"""The port's federated round (repro_torch: stacked engine + device eval)
against the JAX package (repro) on the same numpy inputs and initial
weights, on the CPU: the port's plain versions against the JAX package's
jnp ``ref`` path and its Pallas kernels in interpret mode.

Tolerances: numpy copies are exact; forward values, CE and tied-loss
gradients atol 1e-5 (fp32 products summed in another order); one stacked
Adam + per-client clip step atol 1e-6; relevance W atol 1e-5 and the
dispatched bases B atol 1e-4; retrieval metrics atol 1e-6; the whole
slice's per-eval-round metrics and last W within 1e-4 of the JAX stacked
engine (the bar of ``tests/test_stacked_engine.py``), its byte accounting
exactly equal.

Rehearsal's exemplar order is decided by rounding when an identity has two
training samples (both lie exactly as far from their mean): a 1-ulp
difference between the packages' features reorders the memory, and the
rehearsal draws diverge from the next round on
(``test_exemplar_order_of_two_sample_identity_is_rounding`` pins the
cause). The whole slice is therefore held at 1e-4 in every eval round with
rehearsal off on the bench of ``tests/test_stacked_engine.py``, and with
rehearsal on (the paper's default) on the same bench drawn from a seed in
which no identity has two training samples. On the first bench with
rehearsal on, the first eval round is held at 1e-4 and the later ones at
1e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import batched as JBATCHED
from repro.common.pytree import tree_flatten_stacked
from repro.core import FedSTIL as JFedSTIL
from repro.core import edge_model as JEM
from repro.core.relevance import _ring_push as j_ring_push
from repro.core.relevance import ring_relevance as j_ring_relevance
from repro.core.rehearsal import PrototypeMemory as JMemory
from repro.data import FederatedReIDBenchmark as JBench
from repro.evalreid import evaluate_retrieval_batched
from repro.federated import run_simulation as j_run
from repro.obs import trace as JT
from repro.train import optimizer as JOPT
from repro_torch.comm import batched as PBATCHED
from repro_torch.common.pytree import (flatten_stacked, tree_bytes,
                                       unflatten_stacked)
from repro_torch.core import edge_model as EM
from repro_torch.core.convert import init_params_from_jax, theta_from_jax
from repro_torch.core.fedstil import FedSTIL
from repro_torch.core.rehearsal import PrototypeMemory
from repro_torch.core.relevance import (DeviceRingHistory, normalize_rows,
                                        ring_push, ring_relevance)
from repro_torch.core.similarity import pairwise_similarity
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.evalreid.batched import (batched_retrieval_metrics,
                                          max_match_bound)
from repro_torch.federated import run_simulation
from repro_torch.kernels.ref import batched_topk_pack_ref
from repro_torch.obs import trace as PT
from repro_torch.train.optimizer import adam, apply_updates, clip_by_global_norm

BACKENDS = ["ref", "interpret"]
BENCH_KW = dict(n_clients=3, n_tasks=3, n_identities=60, ids_per_task=10,
                samples_per_id=8, seed=1)
TIE_FREE_SEED = 0      # BENCH_KW's shapes; no identity has 2 train samples
METRICS = ("mAP", "R1", "R5", "forgetting_mAP")


def _event_key(e):
    """What a traced run's event says, without its times and values."""
    return (e["kind"], e.get("name"), e.get("cat"), e.get("round"),
            e.get("direction"), e.get("peer"))


def _same_events(jevents, pevents, tol=1e-4):
    """Both packages' traced runs emit the same events in the same order
    (the meta events' fields too, bar the epoch), each metric's values
    within ``tol``."""
    assert [_event_key(e) for e in pevents] == [_event_key(e)
                                                for e in jevents]
    for a, b in zip(jevents, pevents):
        if a["kind"] == "meta":
            a, b = ({k: v for k, v in e.items() if k != "epoch"}
                    for e in (a, b))
            assert a == b
        elif a["kind"] == "metric":
            assert set(a["values"]) == set(b["values"]), a["name"]
            for k, v in a["values"].items():
                np.testing.assert_allclose(b["values"][k], v, rtol=tol,
                                           atol=tol, err_msg=(a["name"], k))


def _jax_backend(name):
    return None if name == "ref" else name


def _jax_init(C, cfg, seed=0):
    """The JAX engine's own initial weights for ``seed``
    (``repro.federated.simulation``: one key for the trunk, one per
    client)."""
    g_key, *keys = jax.random.split(jax.random.PRNGKey(seed), C + 1)
    return (JEM.init_extraction(g_key, cfg),
            [JEM.init_adaptive_layers(k, cfg) for k in keys])


def _stacked_jax_heads(C, cfg, seed=0):
    _, thetas = _jax_init(C, cfg, seed)
    return jax.tree.map(lambda *xs: np.stack(xs), *thetas)


@pytest.fixture(scope="module")
def cfg():
    return JEM.EdgeModelConfig(n_classes=60)


# ---------------------------------------------------------------------------
# numpy copies and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_bench_equal(seed):
    kw = dict(BENCH_KW, seed=seed)
    jb, pb = JBench(**kw), FederatedReIDBenchmark(**kw)
    for c in range(kw["n_clients"]):
        for t in range(kw["n_tasks"]):
            a, b = jb.task(c, t), pb.task(c, t)
            for f in ("train_x", "train_y", "query_x", "query_y"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert jb.gallery_members(c, 1) == pb.gallery_members(c, 1)
    assert jb.n_classes == pb.n_classes


def test_flatten_columns_in_jax_order(cfg):
    heads = _stacked_jax_heads(3, cfg)
    theta = theta_from_jax(heads, "cpu")
    theta["bn.scale"] = theta["bn.scale"].double()      # a dtype to restore
    mat, meta = flatten_stacked(theta)
    jmat, _ = tree_flatten_stacked(heads)
    assert mat.dtype == torch.float32 and meta[0][:3] == ["bn.bias",
                                                          "bn.scale", "head.w"]
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    back = unflatten_stacked(mat, meta)
    assert back["bn.scale"].dtype == torch.float64
    for k in theta:
        np.testing.assert_array_equal(back[k].numpy(), theta[k].numpy())
    assert tree_bytes({"theta": theta}) == sum(v.numel() * v.element_size()
                                               for v in theta.values())


# ---------------------------------------------------------------------------
# edge model, loss and gradients
# ---------------------------------------------------------------------------


def _batch(rng, C, B, D, n_classes):
    x = np.tanh(rng.standard_normal((C, B, D))).astype(np.float32)
    y = rng.integers(0, n_classes, (C, B)).astype(np.int64)
    return x, y


def test_extraction_forward_and_ce_match_jax(cfg):
    C, B = 3, 20
    rng = np.random.default_rng(0)
    g, _ = _jax_init(C, cfg)
    heads = _stacked_jax_heads(C, cfg)
    imgs = rng.standard_normal((C, B, cfg.img_dim)).astype(np.float32)
    jp = np.asarray(jax.vmap(lambda x: JEM.extract_prototypes(g, x))(imgs))
    pp = EM.extract_prototypes(theta_from_jax(g, "cpu"), torch.from_numpy(imgs))
    np.testing.assert_allclose(pp.numpy(), jp, atol=1e-5)

    x, y = _batch(rng, C, B, cfg.proto_dim, cfg.n_classes)
    theta = theta_from_jax(heads, "cpu")
    jf, jl = jax.vmap(JEM.adaptive_forward)(heads, x)
    pf, pl = EM.adaptive_forward(theta, torch.from_numpy(x))
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5)
    jce = jax.vmap(JEM.ce_loss)(heads, x, y)
    np.testing.assert_allclose(EM.ce_loss(theta, torch.from_numpy(x),
                                          torch.from_numpy(y)).numpy(),
                               np.asarray(jce), atol=1e-5)

    sets = np.tanh(rng.standard_normal((C, 2, 7, cfg.proto_dim))
                   ).astype(np.float32)
    jsf = jax.vmap(lambda th, s: jax.vmap(
        lambda p: JEM.adaptive_forward(th, p)[0])(s))(heads, sets)
    psf = EM.adaptive_features_sets(theta, torch.from_numpy(sets))
    np.testing.assert_allclose(psf.numpy(), np.asarray(jsf), atol=1e-5)


def _fedstil_pair(cfg, C, **kw):
    """A JAX and a port FedSTIL with their stacked states built from the
    same initial heads."""
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    jf, pf = JFedSTIL(cfg, n_clients=C, **kw), FedSTIL(cfg, n_clients=C, **kw)
    jst = jf.stack_states({c: jf.init_client(keys[c]) for c in range(C)})
    pst = pf.stack_states({c: pf.init_client(theta_from_jax(
        JEM.init_adaptive_layers(keys[c], cfg), "cpu")) for c in range(C)})
    return jf, jst, pf, pst


def _set_both(jtree, ptree, key, value):
    group, leaf = key.split(".")
    jtree[group][leaf] = jnp.asarray(value)
    ptree[key] = torch.from_numpy(value)


@pytest.mark.parametrize("trained", [False, True])
def test_tied_loss_gradients_match_jax(cfg, trained):
    """CE + tying gradients w.r.t. (alpha, A). Untrained, theta ==
    theta_prev exactly, so every tying term sits at |0|: JAX's derivative
    there is +1, the port's too (torch.abs would give 0)."""
    C, B = 3, 16
    rng = np.random.default_rng(1)
    jf, jst, pf, pst = _fedstil_pair(cfg, C)
    if trained:
        for k, v in list(pst.trainable["A"].items()):
            _set_both(jst.trainable["A"], pst.trainable["A"], k,
                      rng.standard_normal(v.shape).astype(np.float32) * 0.01)
    x, y = _batch(rng, C, B, cfg.proto_dim, cfg.n_classes)
    ex = jf._stacked_loss_extras(jst)

    def lf(tr, xx, yy, e):
        return jf.loss(tr, xx, yy, e) + jf.regularizer(tr, e)
    jg = jax.vmap(jax.grad(lf))(jst.trainable, jnp.asarray(x),
                                jnp.asarray(y), ex)
    tr = {p: {k: v.clone().requires_grad_(True) for k, v in d.items()}
          for p, d in pst.trainable.items()}
    ext = pf._stacked_loss_extras(pst)
    torch.sum(pf.loss(tr, torch.from_numpy(x), torch.from_numpy(y), ext)
              + pf.regularizer(tr, ext)).backward()
    for part in ("alpha", "A"):
        for k, v in tr[part].items():
            g, leaf = k.split(".")
            np.testing.assert_allclose(v.grad.numpy(),
                                       np.asarray(jg[part][g][leaf]),
                                       atol=1e-5, err_msg=f"{part}.{k}")
    if not trained:
        # BN makes CE blind to l2.b: its gradient is the tying slope lam
        np.testing.assert_allclose(tr["A"]["l2.b"].grad.numpy(), 1e-4,
                                   rtol=1e-3)


def test_adam_and_per_client_clip_match_jax():
    """Two stacked Adam steps with per-client clipping: client 0's
    gradients lie far over the clip norm, client 1's under it, client 2's
    are zero."""
    rng = np.random.default_rng(2)
    shapes = {"w": (3, 5, 4), "b": (3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    scales = np.array([10.0, 0.01, 0.0], np.float32)
    grads = [{k: (rng.standard_normal(s) * scales.reshape(
        (-1,) + (1,) * (len(s) - 1))).astype(np.float32)
        for k, s in shapes.items()} for _ in range(2)]

    jopt = JOPT.adam(lr=1e-3, weight_decay=1e-5)

    def jstep(p, os, g):
        g, _ = JOPT.clip_by_global_norm(g, 1.0)
        u, os = jopt.update(g, os, p)
        return JOPT.apply_updates(p, u), os
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jos = jax.vmap(jopt.init)(jp)
    popt = adam(lr=1e-3, weight_decay=1e-5)
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    pos = popt.init(pp)
    norms = []
    for g in grads:
        jp, jos = jax.vmap(jstep)(jp, jos, {k: jnp.asarray(v)
                                            for k, v in g.items()})
        cg, gn = clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, 1.0)
        norms.append(gn.numpy())
        u, pos = popt.update(cg, pos, pp)
        pp = apply_updates(pp, u)
    assert norms[0][0] > 1.0 and 0.0 < norms[0][1] < 1.0 and norms[0][2] == 0
    assert pos["count"].tolist() == [2, 2, 2]
    for k in shapes:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(pos["m"][k].numpy(),
                                   np.asarray(jos["m"][k]), atol=1e-6)
        np.testing.assert_allclose(pos["v"][k].numpy(),
                                   np.asarray(jos["v"][k]), atol=1e-6)


# ---------------------------------------------------------------------------
# server: ring, relevance, the stacked server round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["kl", "cosine", "euclidean"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_ring_push_and_relevance_match_jax(metric, backend):
    """Five pushes into a k=3 ring (overflow), partial participation from
    the second push on: buffer, validity and staleness equal; relevance
    within 1e-5."""
    C, k, D = 4, 3, 16
    rng = np.random.default_rng(3)
    jb = (jnp.zeros((C, k, D)), jnp.zeros((C, k)), jnp.zeros((C,)))
    pb = (torch.zeros((C, k, D)), torch.zeros((C, k)), torch.zeros((C,)))
    for r in range(5):
        feats = np.tanh(rng.standard_normal((C, D))).astype(np.float32)
        mask = np.ones((C,), np.float32) if r == 0 else \
            (rng.random(C) < 0.6).astype(np.float32)
        jb = j_ring_push(*jb, jnp.asarray(feats), jnp.asarray(mask))
        pb = ring_push(*pb, torch.from_numpy(feats), torch.from_numpy(mask))
        for a, b in zip(jb, pb):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        jW = j_ring_relevance(jb[0], jb[1], forgetting_ratio=0.5,
                              metric=metric, backend=_jax_backend(backend))
        pW = ring_relevance(pb[0], pb[1], forgetting_ratio=0.5, metric=metric)
        np.testing.assert_allclose(pW.numpy(), np.asarray(jW), atol=1e-5)


def test_device_ring_history_zero_rows():
    ring = DeviceRingHistory(3, 2, 4)
    ring.push_all(np.ones((3, 4), np.float32), np.array([1.0, 0.0, 0.0]))
    assert ring.valid[0, 0] == 1.0 and not ring.valid[1:].any()
    assert ring.stale.tolist() == [0.0, 1.0, 1.0]
    W = ring.raw_relevance(forgetting_ratio=0.5)
    assert not W[1:].any()


def test_normalize_rows_equals_reference():
    from repro.core.relevance import normalize_rows as j_normalize_rows
    W = np.random.default_rng(8).random((5, 5)).astype(np.float32)
    W[2] = 0.0
    out = normalize_rows(W)
    np.testing.assert_array_equal(out, j_normalize_rows(W))
    assert not out[2].any()


def test_pairwise_similarity_matches_jax():
    """core.similarity's all-pairs form against the JAX one, all three
    metrics: KL through ``ops.kl_similarity`` (log-softmax, no epsilon)
    against the reference's per-pair form with 1e-12 inside the logs."""
    from repro.core.similarity import pairwise_similarity as j_pairwise
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 12)).astype(np.float32)
    b = rng.standard_normal((7, 12)).astype(np.float32)
    for metric in ("kl", "cosine", "euclidean"):
        np.testing.assert_allclose(
            pairwise_similarity(torch.from_numpy(a), torch.from_numpy(b),
                                metric).numpy(),
            np.asarray(j_pairwise(a, b, metric)), atol=1e-6, err_msg=metric)


@pytest.mark.parametrize("backend", BACKENDS)
def test_server_round_stacked_matches_jax(cfg, backend):
    """Three server rounds of FedSTIL over the same uploads: normalized W
    within 1e-5, dispatched bases within 1e-4, the same nz rows, and the
    keep-old-base rule of apply_dispatch."""
    C = 4
    rng = np.random.default_rng(5)
    jf = JFedSTIL(cfg, n_clients=C, server_backend=_jax_backend(backend))
    pf = FedSTIL(cfg, n_clients=C)
    heads = _stacked_jax_heads(C, cfg)
    jt, pt = JT.Tracer(), PT.Tracer()
    for rnd in range(3):
        theta = jax.tree.map(
            lambda l: (l + 0.1 * rng.standard_normal(l.shape)).astype(
                np.float32), heads)
        feats = np.tanh(rng.standard_normal((C, cfg.proto_dim))
                        ).astype(np.float32)
        with JT.active(jt):
            jd = jf.server_round_stacked(
                rnd, {"theta": theta, "task_feature": jnp.asarray(feats)})
        with PT.active(pt):
            pd = pf.server_round_stacked(rnd, {
                "theta": theta_from_jax(theta, "cpu"),
                "task_feature": torch.from_numpy(feats)})
        np.testing.assert_allclose(pf.last_W, jf.last_W, atol=1e-5)
        np.testing.assert_array_equal(pd["nz"].numpy(), np.asarray(jd["nz"]))
        jB = theta_from_jax(jax.tree.map(np.asarray, jd["B"]), "cpu")
        for k, v in pd["B"].items():
            np.testing.assert_allclose(v.numpy(), jB[k].numpy(), atol=1e-4,
                                       err_msg=k)
    # the server's stage spans and relevance metrics, as the reference's
    assert {e["name"] for e in pt.events if e["kind"] == "span"} == {
        "server.relevance", "server.flatten", "server.aggregate",
        "server.unflatten"}
    _same_events(jt.events, pt.events)

    class _St:
        extras = {"reg_B": {k: torch.zeros_like(v) for k, v in pd["B"].items()}}
    nz = torch.tensor([True, False, True, False])
    out = pf.apply_dispatch_stacked(_St(), {"B": pd["B"], "nz": nz})
    for k, v in out.extras["reg_B"].items():
        assert torch.equal(v[0], pd["B"][k][0]) and not v[1].any()


# ---------------------------------------------------------------------------
# rehearsal exemplars
# ---------------------------------------------------------------------------


def _round0_task(bench, cfg, c):
    g, thetas = _jax_init(bench.n_clients, cfg)
    task = bench.task(c, 0)
    protos = np.asarray(JEM.extract_prototypes(g, task.train_x))
    return protos, task.train_y, thetas[c]


def _exemplars(mem, labels):
    """{identity: stored prototype rows, in memory order}."""
    return {int(i): mem.protos[mem.labels == i] for i in np.unique(labels)}


@pytest.mark.parametrize("client", [0, 1, 2])
def test_add_task_exemplars_equal_on_round0_input(cfg, client):
    """Round 0's exemplar selection (untrained heads): the port's forward
    feeds the port's copy, JAX's forward the original. Every identity
    stores the same exemplars; with three or more samples in the same
    order, with two as the same set (their order is rounding, see the
    next test). On identical outputs the copy equals the original."""
    bench = JBench(**BENCH_KW)
    protos, labels, theta0 = _round0_task(bench, cfg, client)
    jout = np.asarray(JEM.adaptive_forward(theta0, protos)[0])
    th = {k: v[None] for k, v in theta_from_jax(theta0, "cpu").items()}
    pout = EM.adaptive_forward(th, torch.from_numpy(protos.copy())[None])[0]
    jm, pm = JMemory(capacity=2000), PrototypeMemory(capacity=2000)
    jm.add_task(protos, labels, jout, task_id=0)
    pm.add_task(protos, labels, pout[0].numpy(), task_id=0)
    assert pm.size_bytes == jm.size_bytes
    je, pe = _exemplars(jm, labels), _exemplars(pm, labels)
    for ident, rows in je.items():
        if (labels == ident).sum() > 2:
            np.testing.assert_array_equal(pe[ident], rows)
        else:
            assert sorted(map(bytes, pe[ident])) == sorted(map(bytes, rows))
    same = PrototypeMemory(capacity=2000)
    same.add_task(protos, labels, jout, task_id=0)
    for f in ("protos", "labels", "task_ids"):
        np.testing.assert_array_equal(getattr(same, f), getattr(jm, f))


def test_exemplar_order_of_two_sample_identity_is_rounding():
    """The reference's nearest-mean order for an identity with two samples
    is decided by rounding: both lie exactly half their distance from
    their mean, so perturbations far below any tolerance put either one
    first. The port's copy orders them as the original on identical
    outputs; across the packages a 1-ulp difference in the features swaps
    them, and ``mem.sample`` then draws other rehearsal rows."""
    rng = np.random.default_rng(6)
    protos = rng.standard_normal((2, 4)).astype(np.float32)
    labels = np.array([7, 7])
    out = rng.standard_normal((2, 16)).astype(np.float32)
    firsts = set()
    for _ in range(64):
        o = (out * (1 + 1e-6 * rng.standard_normal(out.shape))).astype(
            np.float32)
        jm, pm = JMemory(capacity=10), PrototypeMemory(capacity=10)
        jm.add_task(protos, labels, o, 0)
        pm.add_task(protos, labels, o, 0)
        np.testing.assert_array_equal(pm.protos, jm.protos)
        firsts.add(int((jm.protos[0] == protos[1]).all()))
    assert firsts == {0, 1}


# ---------------------------------------------------------------------------
# batched retrieval metrics
# ---------------------------------------------------------------------------


def _retrieval_problem(rng, C=3, T=2, Q=6, G=40, F=8, n_ids=12):
    qf = rng.standard_normal((C, T, Q, F)).astype(np.float32)
    gf = rng.standard_normal((C, G, F)).astype(np.float32)
    qids = rng.integers(0, n_ids, (C, T, Q)).astype(np.int64)
    gids = rng.integers(0, n_ids, (C, G)).astype(np.int64)
    # exact distance ties: duplicated gallery rows, a match and a
    # non-match, ahead of and behind each other
    gf[:, 5] = gf[:, 3]
    gf[:, 9] = gf[:, 3]
    gids[:, 3], gids[:, 5], gids[:, 9] = qids[:, 0, 0], 99, qids[:, 0, 0]
    qf[:, 0, 1] = gf[:, 3]
    qids[:, 0, 1] = qids[:, 0, 0]
    qmask = (rng.random((C, T, Q)) < 0.8).astype(np.float32)
    gmask = (rng.random((C, G)) < 0.9).astype(np.float32)
    gmask[:, [3, 5, 9]] = 1.0
    qmask[:, 0, :2] = 1.0
    qmask[1, 1] = 0.0                         # a fully padded query set
    return qf, qids, gf, gids, qmask, gmask


@pytest.mark.parametrize("max_matches", [None, 3, 64])
@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_retrieval_metrics_match_jax_and_oracle(backend, max_matches):
    rng = np.random.default_rng(7)
    qf, qids, gf, gids, qmask, gmask = _retrieval_problem(rng)
    bound = max_match_bound(qids, gids, qmask=qmask, gmask=gmask)
    from repro.evalreid.batched import max_match_bound as j_bound
    assert bound == j_bound(qids.astype(np.int32), gids.astype(np.int32),
                            qmask=qmask, gmask=gmask)
    mm = bound if max_matches == 3 else max_matches
    out = batched_retrieval_metrics(
        *map(torch.from_numpy, (qf, qids, gf, gids)),
        qmask=torch.from_numpy(qmask), gmask=torch.from_numpy(gmask),
        max_matches=mm)
    jdev = evaluate_retrieval_batched(
        qf, qids.astype(np.int32), gf, gids.astype(np.int32), qmask=qmask,
        gmask=gmask, backend="device", kernel_backend=_jax_backend(backend),
        max_matches=mm)
    host = evaluate_retrieval_batched(qf, qids, gf, gids, qmask=qmask,
                                      gmask=gmask, backend="host")
    for k in ("mAP", "R1", "R3", "R5"):
        np.testing.assert_allclose(out[k].numpy(), jdev[k], atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), host[k], atol=1e-6,
                                   err_msg=k)
    assert (out["mAP"][1, 1] == 0.0).all()


def test_distance_ties_resolve_by_gallery_order():
    """Duplicated gallery rows: the non-match at index 0 ranks ahead of
    the tied matches, exactly as the stable argsort of the oracle."""
    qf = np.array([[[[1.0, 0.0]]]], np.float32)
    gf = np.array([[[1.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]],
                  np.float32)
    qids = np.array([[[7]]])
    gids = np.array([[3, 7, 7, 5]])
    out = batched_retrieval_metrics(*map(torch.from_numpy,
                                         (qf, qids, gf, gids)))
    assert float(out["R1"]) == 0.0
    np.testing.assert_allclose(float(out["mAP"]), (1 / 2 + 2 / 3) / 2,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _slice_setup(seed):
    kw = dict(BENCH_KW, seed=seed)
    jb, pb = JBench(**kw), FederatedReIDBenchmark(**kw)
    jcfg = JEM.EdgeModelConfig(n_classes=jb.n_classes)
    g, thetas = _jax_init(jb.n_clients, jcfg)
    return jb, pb, jcfg, init_params_from_jax(g, thetas)


@pytest.fixture(scope="module")
def slice_setup():
    return _slice_setup(BENCH_KW["seed"])


def _two_sample_identities(bench):
    return sum(int((np.unique(bench.task(c, t).train_y,
                              return_counts=True)[1] == 2).sum())
               for c in range(bench.n_clients) for t in range(bench.n_tasks))


# case: (rehearsal, bench seed, eval rounds held at 1e-4 (the rest at
# 1e-2), wire codec)
WHOLE_SLICE_CASES = {
    "no_rehearsal": (False, BENCH_KW["seed"], None, None),
    "rehearsal": (True, TIE_FREE_SEED, None, None),
    "rehearsal_two_sample_ties": (True, BENCH_KW["seed"], 1, None),
    "codec_delta_topk": (True, TIE_FREE_SEED, None, "delta+topk"),
}


@pytest.mark.parametrize("case", list(WHOLE_SLICE_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_whole_round_matches_jax_stacked_engine(backend, case):
    """run_simulation of both packages, stacked engine, device eval, C=3,
    T=3, epochs=2, rounds=4, eval_every=2, from the same initial weights.
    The port on the CPU (its plain versions) against JAX with its server
    kernels through ``ref`` and through Pallas interpret. With the
    ``delta+topk`` codec on both directions, the per-round wire and
    formula bytes are equal too (the packages' heads differ by up to ~4e-5
    after a round of Adam, so a few dozen of the 14136 groups of a payload
    keep another element; error feedback carries the rest on, ROADMAP
    Queue 3)."""
    rehearsal, seed, n_tight, codec = WHOLE_SLICE_CASES[case]
    jb, pb, cfg, init = _slice_setup(seed)
    if seed == TIE_FREE_SEED:
        assert _two_sample_identities(pb) == 0
    elif case == "rehearsal_two_sample_ties":
        assert _two_sample_identities(pb) > 0
    jf = JFedSTIL(cfg, n_clients=3, epochs=2, rehearsal=rehearsal,
                  server_backend=_jax_backend(backend), codec=codec)
    jt, pt = JT.Tracer(), PT.Tracer()
    jr = j_run(jf, jb, rounds=4, eval_every=2, engine="stacked", trace=jt)
    pf = FedSTIL(cfg, n_clients=3, epochs=2, rehearsal=rehearsal, codec=codec)
    pr = run_simulation(pf, pb, rounds=4, eval_every=2, engine="stacked",
                        eval_backend="device", device="cpu",
                        init_params=init, trace=pt)
    assert [r["round"] for r in pr.rounds] == [r["round"] for r in jr.rounds]
    for i, (a, b) in enumerate(zip(jr.rounds, pr.rounds)):
        tol = 1e-4 if n_tight is None or i < n_tight else 1e-2
        for key in METRICS:
            assert abs(a[key] - b[key]) < tol, (a["round"], key)
    np.testing.assert_allclose(pf.last_W, jf.last_W, atol=1e-4)
    assert pr.comm.total_c2s == jr.comm.total_c2s
    assert pr.comm.total_s2c == jr.comm.total_s2c
    assert pr.storage_bytes == jr.storage_bytes
    assert set(pr.stage_ms[-1]) >= {"gather", "local_train", "server",
                                    "apply", "eval", "server.aggregate"}
    assert pr.comm.measured == jr.comm.measured == (codec is not None)
    assert pr.comm_breakdown() == jr.comm_breakdown()
    if codec is not None:
        assert {"encode_c2s", "encode_s2c"} <= set(pr.stage_ms[-1])
        assert pr.comm.total < pr.comm.total_formula
    # traced, both packages emit the same events; the relevance and
    # encode metrics within 1e-4
    _same_events(jt.events, pt.events)


@pytest.mark.parametrize("codec", [None, "delta+topk"])
@pytest.mark.parametrize("engine", ["stacked", "host"])
def test_tracing_changes_no_result_and_untraced_does_no_work(
        slice_setup, monkeypatch, engine, codec):
    """The same port run untraced and traced: equal metrics, bytes, last W
    and delta-codec references, bit for bit. Untraced, no span waits on
    the device, the encode computes no metric and ``stage_ms`` is empty;
    traced, each round's ``stage_ms`` entries are its spans' totals."""
    _, pb, cfg, init = slice_setup
    calls = {"sync": 0, "enc_metrics": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(PT._Span, "sync", counted("sync", PT._Span.sync))
    monkeypatch.setattr(PBATCHED.BatchedCodec, "_enc_metrics", counted(
        "enc_metrics", PBATCHED.BatchedCodec._enc_metrics))

    def run(trace):
        st = FedSTIL(cfg, n_clients=3, epochs=1, codec=codec)
        res = run_simulation(st, pb, rounds=3, eval_every=2, engine=engine,
                             device="cpu", init_params=init, trace=trace)
        return st, res

    su, ru = run(None)
    assert calls == {"sync": 0, "enc_metrics": 0} and ru.stage_ms == []
    tracer = PT.Tracer()
    st, rt = run(tracer)
    # the host engine's spans wait on the device only around its codec, as
    # the reference's do
    assert (calls["sync"] > 0) == (engine == "stacked" or codec is not None)
    assert (calls["enc_metrics"] > 0) == (codec is not None
                                          and engine == "stacked")
    assert rt.rounds == ru.rounds
    assert rt.comm_breakdown() == ru.comm_breakdown()
    assert rt.storage_bytes == ru.storage_bytes
    np.testing.assert_array_equal(st.last_W, su.last_W)
    for key, prog in su._wire_programs.items():
        assert torch.equal(st._wire_programs[key]._enc_ref, prog._enc_ref)

    spans = [e for e in tracer.events if e["kind"] == "span"]
    stage_of = {"comm.upload": "encode_c2s", "comm.dispatch": "encode_s2c",
                "round.gather": "gather", "round.local_train": "local_train",
                "round.server": "server", "round.apply": "apply",
                "round.eval": "eval"}
    want = {}
    for e in spans:
        key = ("encode_" + e["peer"][0] if "peer" in e
               else stage_of.get(e["name"], e["name"]))
        want[key] = want.get(key, 0.0) + e["dur"] * 1e3
    want.pop("round.encode", None)
    got = {k: sum(r.get(k, 0.0) for r in rt.stage_ms) for k in want}
    assert got == pytest.approx(want, rel=1e-12)
    assert [r["round"] for r in rt.stage_ms] == [0, 1, 2]
    assert all(r["wall_ms"] >= r["local_train"] > 0.0 for r in rt.stage_ms)
    assert ({"encode_c2s", "encode_s2c"} <= set(rt.stage_ms[-1])) == (
        codec is not None)


# (codec, options, metric tolerance). Stateless top-k sparsifies the
# absolute heads from the first payload on: after one Adam step every bias
# and BN entry has moved by almost exactly the learning rate, so a group's
# magnitudes tie to an ulp or two, the packages' last-bit differences keep
# another element in ~27 of 10776 groups, and no error feedback undoes it
# (1.5e-4 mAP here; ROADMAP Queue 3). The delta codecs ship a dense
# keyframe first and feed dropped coordinates back.
CODEC_SPECS = [("raw", {}, 1e-4), ("delta", {}, 1e-4), ("topk", {}, 1e-4),
               ("topk", {"delta": False}, 1e-3)]


@pytest.mark.parametrize("codec,opts,tol", CODEC_SPECS,
                         ids=[f"{c}-{o}" for c, o, _ in CODEC_SPECS])
def test_codec_specs_run_the_round_as_jax(slice_setup, codec, opts, tol):
    """The slice's other wire codecs through the stacked round (C=3, two
    rounds, one epoch): per-round wire and formula bytes equal to the JAX
    stacked engine's, metrics within ``tol``; the dense codecs are
    lossless, so their metrics equal the uncoded run's."""
    jb, pb, cfg, init = slice_setup
    jr = j_run(JFedSTIL(cfg, n_clients=3, epochs=1, rehearsal=False,
                        codec=codec, codec_opts=opts), jb, rounds=2,
               eval_every=2, engine="stacked")
    pr = run_simulation(FedSTIL(cfg, n_clients=3, epochs=1, rehearsal=False,
                                codec=codec, codec_opts=opts), pb, rounds=2,
                        eval_every=2, engine="stacked", device="cpu",
                        init_params=init)
    assert pr.comm.measured and pr.comm_breakdown() == jr.comm_breakdown()
    for key in METRICS:
        assert abs(jr.final(key) - pr.final(key)) < tol, key
    if codec in ("raw", "delta"):
        plain = run_simulation(FedSTIL(cfg, n_clients=3, epochs=1,
                                       rehearsal=False), pb, rounds=2,
                               eval_every=2, engine="stacked", device="cpu",
                               init_params=init)
        assert pr.rounds == plain.rounds


def _kept_sets(mat):
    """(C, nb, 3) sorted absolute indices each group of 8 keeps at kg 3."""
    idx = batched_topk_pack_ref(torch.from_numpy(np.array(mat)), group=8,
                                kg=3)[1].numpy()
    return np.sort(idx.reshape(idx.shape[0], -1, 3), -1)


def test_stateless_topk_selection_flips_are_last_bit_ties(slice_setup,
                                                          monkeypatch):
    """Why stateless top-k holds the JAX round only to 1e-3: its first
    payload sparsifies the heads right after one Adam step, which moves
    every bias and BN entry by almost exactly the learning rate. The two
    packages' heads then differ in the last bits only, yet some groups keep
    another element: in each such group the elements kept by one package
    and dropped by the other have magnitudes within 1e-6 of each other,
    relative (about 8 fp32 ulps; they sit at lr * (1 - 6e-4))."""
    seen = {"jax": [], "port": []}
    for mod, tag, conv in ((JBATCHED, "jax", np.asarray),
                           (PBATCHED, "port", lambda t: t.numpy())):
        orig = mod.BatchedCodec.roundtrip

        def record(self, mat, _orig=orig, _tag=tag, _conv=conv):
            seen[_tag].append(_conv(mat))
            return _orig(self, mat)
        monkeypatch.setattr(mod.BatchedCodec, "roundtrip", record)
    jb, pb, cfg, init = slice_setup
    kw = dict(n_clients=3, epochs=1, rehearsal=False, codec="topk",
              codec_opts={"delta": False})
    j_run(JFedSTIL(cfg, **kw), jb, rounds=1, eval_every=1, engine="stacked")
    run_simulation(FedSTIL(cfg, **kw), pb, rounds=1, eval_every=1,
                   engine="stacked", device="cpu", init_params=init)
    jm, pm = seen["jax"][0], seen["port"][0]          # round 0's upload
    assert np.abs(jm - pm).max() < 1e-5
    js, ps = _kept_sets(jm), _kept_sets(pm)
    flipped = np.argwhere((js != ps).any(-1))
    n_groups = js.shape[0] * js.shape[1]
    assert 0 < len(flipped) < 0.01 * n_groups, (len(flipped), n_groups)
    for c, g in flipped:
        only = np.setxor1d(js[c, g], ps[c, g])
        mags = np.abs(jm[c, only])
        assert np.abs(mags - mags[0]).max() <= 1e-6 * mags[0], (c, g, mags)


def test_run_simulation_refuses_what_later_slices_bring(slice_setup):
    """No engine is refused any more: the scale-out slice brought the
    sharded engine (a world of one here; ``test_torch_sharded.py`` holds
    it to JAX); what the host-engine slice brought runs: the host engine
    (the default, as in the reference), host evaluation on every engine,
    the quantized codecs and the loop server backend."""
    _, pb, cfg, init = slice_setup
    for kw in ({}, {"engine": "host", "eval_backend": "host"},
               {"engine": "stacked", "eval_backend": "host"},
               {"engine": "sharded"},
               {"engine": "sharded", "eval_backend": "host"}):
        res = run_simulation(FedSTIL(cfg, n_clients=3, epochs=1), pb,
                             rounds=1, device="cpu", init_params=init,
                             trace=PT.Tracer(), **kw)
        assert len(res.rounds) == 1
        assert ("gather" in res.stage_ms[0]) == (kw.get("engine", "host")
                                                 != "host")
    for codec, quant in (("topk+int8", "int8"), ("int8", "int8"),
                         ("bf16", "bf16")):
        st = FedSTIL(cfg, n_clients=3, codec=codec)
        assert st.upload_codec.quant == st.dispatch_codec.quant == quant
    assert FedSTIL(cfg, n_clients=3, server_backend="loop").tracker.backend \
        == "loop"
    with pytest.raises(ValueError, match="'loop'"):
        FedSTIL(cfg, n_clients=3, server_backend="pallas")
    with pytest.raises(ValueError, match="global top-k"):
        run_simulation(FedSTIL(cfg, n_clients=3, epochs=1, codec="topk",
                               codec_opts={"k": 10}), pb, rounds=1,
                       engine="stacked", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        run_simulation(FedSTIL(cfg, n_clients=3), pb, engine="mesh",
                       device="cpu")


@pytest.mark.parametrize("switch", ["st_integration", "tying"])
def test_ablation_switches_run(slice_setup, switch):
    """Table III ablations on the port: without spatial-temporal
    integration no base is dispatched (S2C bytes 0); without tying the
    round still trains. Both match the JAX package's bytes."""
    jb, pb, cfg, init = slice_setup
    kw = {switch: False}
    jr = j_run(JFedSTIL(cfg, n_clients=3, epochs=1, **kw), jb, rounds=2,
               eval_every=2, engine="stacked")
    pr = run_simulation(FedSTIL(cfg, n_clients=3, epochs=1, **kw), pb,
                        rounds=2, eval_every=2, engine="stacked",
                        device="cpu", init_params=init)
    assert pr.comm.total_s2c == jr.comm.total_s2c
    assert pr.comm.total_c2s == jr.comm.total_c2s
    for key in METRICS:
        assert abs(jr.final(key) - pr.final(key)) < 1e-4, key
