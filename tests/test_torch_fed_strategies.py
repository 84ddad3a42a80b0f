"""The port's federated Table II baselines (repro_torch: ``FedProx``,
``FedCurv``, ``FedWeIT``) against the JAX package (repro) on the same
numpy inputs and initial weights, on the CPU; and the port's pytree order
on integer keys (FedWeIT's neighbour dicts) against ``jax.tree.flatten``.

Tolerances: the host engine within 1e-4 in every eval round (the bar of
``tests/test_torch_host_engine.py``), bytes and storage equal; the Fisher
within 1e-6 of its largest entry; the regularizers' (C,) penalties within
1e-6 relative and their gradients within 1e-6 of the largest.

FedWeIT's bytes are equal up to exact ties at its top-30% threshold. Its
``l2.b`` feeds the BN layer, which takes out any per-feature shift, so the
cross-entropy gradient of that leaf is zero in exact arithmetic: each
package computes rounding there, and A's ``l2.b`` entries move by the l1
term alone: their whole spread (3e-7 to 2.3e-6) is of the order of the
packages' difference (4e-7 to 1.9e-6). Which 19 of the 64 the top-30%
keeps is then decided by rounding, differently in the two packages (every
other leaf keeps the same entries), and where one package's k-th
magnitude is an exact tie it keeps one entry more: 8 bytes up, 8 per
client down. The metrics do not see it (BN erases ``l2.b``): they agree
within 1e-4. ``test_fedweit_selection_differs_only_where_bn_erases_the_
gradient`` pins this; ROADMAP Queue 3 records it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import pytree as JPT
from repro.comm.codec import make_codec as j_make_codec
from repro.core import edge_model as JEM
from repro.data import FederatedReIDBenchmark as JBench
from repro.federated import FedAvg as JFedAvg
from repro.federated import FedCurv as JFedCurv
from repro.federated import FedProx as JFedProx
from repro.federated import FedWeIT as JFedWeIT
from repro.federated import run_simulation as j_run
from repro_torch.comm.codec import make_codec
from repro_torch.common import pytree as PT
from repro_torch.core import edge_model as EM
from repro_torch.core.convert import (init_params_from_jax, theta_from_jax,
                                      theta_to_jax)
from repro_torch.core.fedstil import FedSTIL
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated import (FedAvg, FedCurv, FedProx, FedWeIT,
                                   run_simulation)
from repro_torch.federated.base import as_one
from repro_torch.federated.base import fisher_diag
from repro_torch.lifelong import EWC, MAS, STL, ICaRL

BENCH_KW = dict(n_clients=3, n_tasks=3, n_identities=60, ids_per_task=10,
                samples_per_id=8)
TIE_FREE_SEED = 0          # no identity has two training samples
METRICS = ("mAP", "R1", "R5", "forgetting_mAP")
# tests/test_torch_host_engine.py's bar for a quantized codec against JAX
CODED_TOL = {"mAP": 5e-3, "forgetting_mAP": 1e-2, "R1": 2e-2, "R5": 2e-2}


@functools.lru_cache(maxsize=None)
def _setup(seed=TIE_FREE_SEED):
    kw = dict(BENCH_KW, seed=seed)
    jb, pb = JBench(**kw), FederatedReIDBenchmark(**kw)
    cfg = JEM.EdgeModelConfig(n_classes=jb.n_classes)
    g_key, *keys = jax.random.split(jax.random.PRNGKey(0), jb.n_clients + 1)
    init = init_params_from_jax(JEM.init_extraction(g_key, cfg),
                                [JEM.init_adaptive_layers(k, cfg)
                                 for k in keys])
    return jb, pb, cfg, init


def _port_run(strategy, bench, init, **kw):
    return run_simulation(strategy, bench, device="cpu", init_params=init,
                          **kw)


def _close(jr, pr, tol):
    assert [r["round"] for r in pr.rounds] == [r["round"] for r in jr.rounds]
    worst = {k: max(abs(a[k] - b[k]) for a, b in zip(jr.rounds, pr.rounds))
             for k in METRICS}
    for k, v in worst.items():
        bar = tol[k] if isinstance(tol, dict) else tol
        assert v < bar, (k, v, bar)
    return worst


def _same_bytes(jr, pr):
    assert pr.comm.total_c2s == jr.comm.total_c2s
    assert pr.comm.total_s2c == jr.comm.total_s2c
    assert pr.comm.measured == jr.comm.measured
    assert pr.comm_breakdown() == jr.comm_breakdown()
    assert pr.storage_bytes == jr.storage_bytes


def _flat_np(tree):
    """A JAX nested head or a port flat head -> flat dotted numpy dict."""
    if any(isinstance(v, dict) for v in tree.values()):
        tree = theta_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v) for k, v in tree.items()}


def _recording(cls):
    """``cls`` that keeps every upload's (round, client, A, nnz)."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.uploads, self.dense_A = [], []

        def local_train(self, client, state, protos, labels, rnd, **kw):
            state, up = super().local_train(client, state, protos, labels,
                                             rnd, **kw)
            self.uploads.append((rnd, client, _flat_np(up["A"]),
                                 int(up["A_nnz"])))
            self.dense_A.append(_flat_np(state.theta["A"]))
            return state, up
    return Recording


# ---------------------------------------------------------------------------
# the host engine against the JAX host engine
# ---------------------------------------------------------------------------

STRATEGIES = {
    "fedprox": (JFedProx, FedProx, {}),
    "fedcurv": (JFedCurv, FedCurv, {}),
    "fedweit": (_recording(JFedWeIT), _recording(FedWeIT), {"n_clients": 3}),
}


@functools.lru_cache(maxsize=None)
def _host_runs(name):
    jb, pb, cfg, init = _setup()
    J, P, kw = STRATEGIES[name]
    js, ps = J(cfg, epochs=2, **kw), P(cfg, epochs=2, **kw)
    jr = j_run(js, jb, rounds=4, eval_every=2)
    pr = _port_run(ps, pb, init, rounds=4, eval_every=2, engine="host")
    return js, jr, ps, pr


def _tie_excess(A):
    """Entries kept beyond k = max(1, int(0.3 size)) per leaf: the ties at
    each leaf's threshold."""
    out = 0
    for a in A.values():
        flat = np.abs(a).ravel()
        k = max(1, int(0.3 * flat.size))
        out += int(np.count_nonzero(flat >= np.sort(flat)[-k])) - k
    return out


def _fedweit_bytes_up_to_ties(js, jr, ps, pr):
    """Every upload's nnz is k (the same in both packages) plus its own
    ties at the threshold; the comm rows differ by exactly the ties' 8
    bytes, once up and once to each client down; storage is equal."""
    C = len({c for _, c, _, _ in js.uploads})
    extra = {}
    for (r, c, ja, jn), (r2, c2, pa, pn) in zip(js.uploads, ps.uploads):
        assert (r, c) == (r2, c2) and set(ja) == set(pa)
        k = sum(max(1, int(0.3 * a.size)) for a in ja.values())
        assert jn == k + _tie_excess(ja) and pn == k + _tie_excess(pa)
        assert sum(int(np.count_nonzero(a)) for a in pa.values()) == pn
        extra[r] = extra.get(r, 0) + pn - jn
    assert all(abs(e) <= C for e in extra.values()), extra
    for jrow, prow in zip(jr.comm_breakdown(), pr.comm_breakdown()):
        r = jrow["round"]
        assert prow["c2s_formula"] - jrow["c2s_formula"] == 8 * extra[r]
        assert prow["s2c_formula"] - jrow["s2c_formula"] == 8 * C * extra[r]
    assert pr.storage_bytes == jr.storage_bytes
    return extra


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_host_engine_matches_jax_host_engine(name):
    """run_simulation(engine="host") of both packages, C=3, T=3, epochs 2,
    rounds 4, eval every 2, from the same initial weights: every eval
    round within 1e-4, bytes and storage equal (FedWeIT: up to the ties
    at its threshold, module docstring)."""
    js, jr, ps, pr = _host_runs(name)
    _close(jr, pr, 1e-4)
    if name == "fedweit":
        _fedweit_bytes_up_to_ties(js, jr, ps, pr)
    else:
        _same_bytes(jr, pr)
    if name == "fedcurv":        # theta + F + F theta, up and down
        head = sum(v.nbytes for v in _setup()[3]["theta0"][0].values())
        assert pr.comm.total_c2s == pr.comm.total_s2c == 4 * 3 * 3 * head
        assert pr.storage_bytes == 3 * head


def test_fedweit_selection_differs_only_where_bn_erases_the_gradient():
    """Why FedWeIT's bytes differ by ties (module docstring): the packages
    keep the same entries of every leaf of A but ``l2.b``, whose dense
    entries differ between them by a fifth of their whole spread or more
    (measured 4e-7 to 1.9e-6 against spreads of 3e-7 to 2.3e-6), so that
    every entry kept by one package and dropped by the other lies within
    twice that difference of the threshold; and ``l2.b``'s cross-entropy
    gradient is rounding in both packages (BN follows it), against
    gradients above 1e-4 elsewhere. (The dense A agree within 3e-5: a
    first Adam step on a near-zero gradient moves an entry by lr g / (|g|
    + eps), which carries the packages' relative difference of a tiny g.)
    """
    js, _, ps, _ = _host_runs("fedweit")
    flips = 0
    for (_, _, ja, _), (_, _, pa, _), jd, pd in zip(
            js.uploads, ps.uploads, js.dense_A, ps.dense_A):
        for key in ja:
            assert np.abs(jd[key] - pd[key]).max() < 3e-5, key
            if key != "l2.b":
                np.testing.assert_array_equal(ja[key] != 0, pa[key] != 0,
                                              err_msg=key)
        delta = np.abs(jd["l2.b"] - pd["l2.b"]).max()
        mag = np.abs(pd["l2.b"])
        assert delta > 0.2 * (mag.max() - mag.min())
        k = max(1, int(0.3 * jd["l2.b"].size))
        for d, sp in ((jd["l2.b"], ja["l2.b"]), (pd["l2.b"], pa["l2.b"])):
            thr = np.sort(np.abs(d))[-k]
            flipped = (ja["l2.b"] != 0) != (pa["l2.b"] != 0)
            assert np.all(np.abs(np.abs(d[flipped]) - thr) <= 2 * delta)
        flips += int(flipped.sum())
    assert flips > 0
    _, pb, cfg, init = _setup()
    head = {k: torch.from_numpy(v) for k, v in init["theta0"][0].items()}
    protos, labels = _protos(cfg, 64)
    theta = PT.tree_map(lambda t: t[None].clone().requires_grad_(True), head)
    EM.ce_loss(theta, torch.from_numpy(protos)[None],
               torch.from_numpy(labels.astype(np.int64))[None]).sum().backward()
    g = {k: float(t.grad.abs().max()) for k, t in theta.items()}
    jg = _flat_np(jax.grad(JEM.ce_loss)(theta_to_jax(head), protos, labels))
    assert g["l2.b"] < 1e-6 * g["l2.w"] and np.abs(jg["l2.b"]).max() < 1e-6 * \
        np.abs(jg["l2.w"]).max()
    assert min(v for k, v in g.items() if k != "l2.b") > 1e-4


def test_fedprox_stacked_matches_jax_stacked_and_the_port_host():
    """FedProx on ``engine="stacked"`` against the JAX stacked engine and
    the port's host engine: every eval round within 1e-4, bytes equal."""
    jb, pb, cfg, init = _setup()
    jr = j_run(JFedProx(cfg, epochs=2), jb, rounds=4, eval_every=2,
               engine="stacked")
    pr = _port_run(FedProx(cfg, epochs=2), pb, init, rounds=4, eval_every=2,
                   engine="stacked")
    _close(jr, pr, 1e-4)
    _same_bytes(jr, pr)
    _, _, _, host = _host_runs("fedprox")
    _close(host, pr, 1e-4)
    assert host.comm.total_c2s == pr.comm.total_c2s
    assert host.comm.total_s2c == pr.comm.total_s2c
    assert host.storage_bytes == pr.storage_bytes


# ---------------------------------------------------------------------------
# unit parity: the Fisher, the regularizers, FedWeIT's theta and first step
# ---------------------------------------------------------------------------


def _protos(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.standard_normal((n, cfg.proto_dim))).astype(
        np.float32), rng.integers(0, cfg.n_classes, n).astype(np.int32))


def _heads(cfg, C, seed):
    rng = np.random.default_rng(seed)
    shapes = {k: v.shape for k, v in _setup()[3]["theta0"][0].items()}
    return [{k: (rng.standard_normal(s) * 0.3).astype(np.float32)
             for k, s in shapes.items()} for _ in range(C)]


def _close_trees(got, want, rel):
    """Leaf by leaf within ``rel`` of the tree's largest |value|."""
    got, want = _flat_np(got), _flat_np(want)
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=rel * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("n", [61, 16])
def test_fisher_matches_jax(n):
    """FedCurv's Fisher (chunks of 8 of the first n prototypes, a ragged
    tail dropped) against the reference's ``_fisher``: within 1e-6 of its
    largest entry."""
    _, _, cfg, init = _setup()
    head = init["theta0"][1]
    protos, labels = _protos(cfg, n)
    want = jax.jit(JFedCurv(cfg)._fisher)(
        theta_to_jax(head), jnp.asarray(protos), jnp.asarray(labels))
    got = fisher_diag({k: torch.from_numpy(v) for k, v in head.items()},
                      protos, labels)
    _close_trees(got, want, 1e-6)


def _regularizer_cases(cfg):
    heads = _heads(cfg, 3, 11)
    anchors = _heads(cfg, 3, 12)
    fishers = [{k: np.abs(v) for k, v in h.items()} for h in _heads(cfg, 3, 13)]
    weit = [{"mask": h, "A": a, "attn": np.zeros(3, np.float32)}
            for h, a in zip(heads, anchors)]
    return {
        "fedprox": (JFedProx(cfg, mu=0.5), FedProx(cfg, mu=0.5), heads,
                    [{"reg_global": a} for a in anchors]),
        "fedcurv": (JFedCurv(cfg, lam=0.3), FedCurv(cfg, lam=0.3), heads,
                    [{"reg_fisher_sum": f, "reg_fisher_theta_sum": a}
                     for f, a in zip(fishers, anchors)]),
        "fedweit": (JFedWeIT(cfg, l1=1e-2, l2=1e-1, n_clients=3),
                    FedWeIT(cfg, l1=1e-2, l2=1e-1, n_clients=3), weit,
                    [{} for _ in range(3)]),
    }


def _to_jax_tree(tree):
    if isinstance(tree, dict) and any(isinstance(v, dict) for v in
                                      tree.values()):
        return {k: _to_jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, dict) and any("." in k for k in tree):
        return theta_to_jax(tree)
    if isinstance(tree, dict):
        return {k: jnp.asarray(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _to_port_stack(trees):
    return PT.tree_stack([PT.tree_map(torch.from_numpy, t) for t in trees])


@pytest.mark.parametrize("name", ["fedprox", "fedcurv", "fedweit"])
def test_regularizer_penalties_and_gradients_match_jax(name):
    """The port's (C,) penalties of a stack of three clients against the
    reference's scalar of each client, and the gradients of their sum
    against ``jax.grad`` of each (FedWeIT's l1 at A != 0 here; its slope at
    0 is the next test's)."""
    _, _, cfg, _ = _setup()
    J, P, trainables, extras = _regularizer_cases(cfg)[name]
    tr = PT.tree_map(lambda t: t.requires_grad_(True),
                     _to_port_stack(trainables))
    ex = _to_port_stack(extras) if extras[0] else {}
    pen = P.regularizer(tr, ex)
    assert pen.shape == (3,)
    pen.sum().backward()
    for c in range(3):
        jt, je = _to_jax_tree(trainables[c]), _to_jax_tree(extras[c])
        want = float(J.regularizer(jt, je))
        assert abs(float(pen[c].detach()) - want) <= 1e-6 * abs(want), (c, want)
        jg = jax.grad(J.regularizer)(jt, je)
        if name == "fedweit":        # a penalty on A alone
            _close_trees(PT.tree_map(lambda t: t.grad[c], tr["A"]), jg["A"],
                         1e-6)
            assert all(t.grad is None for t in PT.tree_leaves(
                {"mask": tr["mask"], "attn": tr["attn"]}))
            assert not any(np.any(v) for v in jax.tree.leaves(
                {"mask": jg["mask"], "attn": jg["attn"]}))
        else:
            _close_trees(PT.tree_map(lambda t: t.grad[c], tr), jg, 1e-6)


def _weit_state(cfg, rng):
    head = _heads(cfg, 1, 21)[0]
    neighbours = {k: (rng.standard_normal((3,) + v.shape) * 0.1).astype(
        np.float32) for k, v in head.items()}
    trainable = {"mask": _heads(cfg, 1, 22)[0], "A": _heads(cfg, 1, 23)[0],
                 "attn": rng.standard_normal(3).astype(np.float32)}
    return head, neighbours, trainable


def test_fedweit_make_theta_matches_jax():
    """b sigmoid(m) + a + sum_c softmax(attn)_c nb_c on a stack of two
    clients against the reference's per client: within 1e-6 of the
    largest entry."""
    _, _, cfg, _ = _setup()
    rng = np.random.default_rng(5)
    states = [_weit_state(cfg, rng) for _ in range(2)]
    J, P = JFedWeIT(cfg, n_clients=3), FedWeIT(cfg, n_clients=3)
    got = P.make_theta(
        _to_port_stack([s[2] for s in states]),
        {"reg_base": _to_port_stack([s[0] for s in states]),
         "reg_neighbors": _to_port_stack([s[1] for s in states])})
    for c, (head, neigh, trainable) in enumerate(states):
        want = J.make_theta(_to_jax_tree(trainable), {
            "reg_base": theta_to_jax(head),
            "reg_neighbors": theta_to_jax(neigh)})
        _close_trees(PT.tree_slice(got, c), want, 1e-6)


def test_fedweit_first_step_gradient_at_zero_matches_jax():
    """The first step starts at A = 0 exactly, where the l1 term's slope
    is JAX's +1 (``torch.abs`` would give 0): the gradient of loss +
    regularizer on a fresh client equals the reference's within 1e-6 of
    the largest, and on ``l2.b`` (no cross-entropy gradient, BN follows
    it) it is the l1 weight itself."""
    _, _, cfg, init = _setup()
    head = init["theta0"][0]
    protos, labels = _protos(cfg, 64, seed=8)
    J, P = JFedWeIT(cfg, n_clients=3), FedWeIT(cfg, n_clients=3)
    st = P.init_client({k: torch.from_numpy(v) for k, v in head.items()})
    ex = P._loss_extras(st)
    tr = PT.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     as_one(st.theta))
    x = torch.from_numpy(protos)[None]
    y = torch.from_numpy(labels.astype(np.int64))[None]
    (P.loss(tr, x, y, ex) + P.regularizer(tr, ex)).sum().backward()
    jst = J.init_client(jax.random.PRNGKey(0))
    jex = {"reg_base": theta_to_jax(head),
           "reg_neighbors": jax.tree.map(jnp.zeros_like,
                                         jst.extras["reg_neighbors"])}
    jtr = {"mask": jax.tree.map(jnp.ones_like, jex["reg_base"]),
           "A": jax.tree.map(jnp.zeros_like, jex["reg_base"]),
           "attn": jnp.zeros((3,))}
    jg = jax.jit(jax.grad(lambda th: J.loss(th, protos, labels, jex)
                          + J.regularizer(th, jex)))(jtr)
    for part in ("A", "mask"):
        _close_trees(PT.tree_map(lambda t: t.grad[0], tr[part]), jg[part],
                     1e-6)
    np.testing.assert_allclose(tr["attn"].grad[0].numpy(),
                               np.asarray(jg["attn"]), atol=1e-9)
    np.testing.assert_allclose(tr["A"]["l2.b"].grad[0].numpy(), P.l1,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# FedWeIT's accounting and codec
# ---------------------------------------------------------------------------


def test_fedweit_sparse_bytes_match_a_lossless_encoding():
    """``tests/test_comm_codec.py::test_fedweit_sparse_bytes_matches_
    measured`` on the port: ties at the threshold keep more than k
    entries, the formula counts the real nonzeros (as the reference's
    does on the same tree), and a lossless global top-nnz encoding of the
    sparse tree measures exactly that many bytes and decodes it back."""
    cfg = EM.EdgeModelConfig(n_classes=16)
    s = FedWeIT(cfg, n_clients=3)
    rng = np.random.default_rng(7)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    k = int(0.3 * w.size)
    order = np.argsort(-np.abs(w).ravel())
    w.ravel()[order[k:k + 4]] = np.abs(w).ravel()[order[k - 1]]  # 4 ties
    A = {"l1.w": torch.from_numpy(w), "l1.b": torch.from_numpy(
        rng.standard_normal(16).astype(np.float32))}
    sp = s._sparsify(A)
    nnz = sum(int(torch.count_nonzero(v)) for v in sp.values())
    jsp = JFedWeIT(EM.EdgeModelConfig(n_classes=16), n_clients=3)._sparsify(
        {"l1": {"w": jnp.asarray(w), "b": jnp.asarray(A["l1.b"].numpy())}})
    _close_trees(sp, jsp, 0.0)
    assert s.sparse_bytes(sp) == nnz * 8
    assert nnz == k + 4 + int(0.3 * 16)
    payload = make_codec("topk", k=nnz, delta=False).encode(sp)
    assert payload.nbytes == s.sparse_bytes(sp)
    jpay = j_make_codec("topk", k=nnz, delta=False).encode(jsp)
    assert jpay.nbytes == payload.nbytes
    dec = make_codec("topk", k=nnz, delta=False).decode(payload)
    for k, v in sp.items():
        np.testing.assert_array_equal(dec[k], v.numpy())


def test_fedweit_int8_keeps_counters_off_the_wire(monkeypatch):
    """``codec="int8"``: the nnz counters ship verbatim (none reaches the
    codec, which walks the int-keyed neighbour dicts), every round's wire
    bytes equal the reference's, measured < formula, metrics finite."""
    jb, pb, cfg, init = _setup(1)
    seen = []
    orig = type(make_codec("int8")).roundtrip

    def record(self, tree, peer=None):
        seen.append(PT.leaf_paths(tree))
        return orig(self, tree, peer=peer)
    monkeypatch.setattr(type(make_codec("int8")), "roundtrip", record)
    kw = dict(epochs=2, n_clients=3, codec="int8")
    jr = j_run(JFedWeIT(cfg, **kw), jb, rounds=2, eval_every=2)
    pr = _port_run(FedWeIT(cfg, **kw), pb, init, rounds=2, eval_every=2)
    assert pr.comm.measured and pr.comm.total < pr.comm.total_formula
    assert [(r["c2s_wire"], r["s2c_wire"]) for r in pr.comm_breakdown()] == \
        [(r["c2s_wire"], r["s2c_wire"]) for r in jr.comm_breakdown()]
    assert np.isfinite(pr.final("mAP"))
    assert len(seen) == 2 * 3 * 2
    assert not any("nnz" in str(p) for paths in seen for p in paths)
    down = [paths for paths in seen if paths[0][0] == "neighbors"]
    assert down and all([p[1] for p in paths][::len(paths) // 3] == [0, 1, 2]
                        for paths in down)


INT8_RUNS = [("fedavg", "host"), ("fedprox", "host"), ("fedprox", "stacked")]


@pytest.mark.parametrize("name,engine", INT8_RUNS,
                         ids=[f"{n}-{e}" for n, e in INT8_RUNS])
def test_mean_strategies_under_int8_match_jax(name, engine):
    """FedAvg and FedProx with the dense int8 codec against the reference,
    C=3, rounds 3: every round's wire and formula bytes equal, metrics
    within ``CODED_TOL``."""
    jb, pb, cfg, init = _setup()
    J, P = {"fedavg": (JFedAvg, FedAvg), "fedprox": (JFedProx, FedProx)}[name]
    kw = dict(epochs=2, codec="int8")
    jr = j_run(J(cfg, **kw), jb, rounds=3, eval_every=3, engine=engine)
    pr = _port_run(P(cfg, **kw), pb, init, rounds=3, eval_every=3,
                   engine=engine)
    _close(jr, pr, CODED_TOL)
    _same_bytes(jr, pr)
    assert pr.comm.total < 0.30 * pr.comm.total_formula


def test_table2_byte_ordering():
    """``tests/test_federated.py::test_comm_cost_ordering`` on the port:
    local methods move nothing, FedCurv more than 2.5x FedAvg, FedSTIL's
    upload within 1.2x FedAvg's."""
    _, pb, cfg, init = _setup(1)
    run = lambda s: _port_run(s, pb, init, rounds=3, eval_every=3)
    stl, avg = run(STL(cfg, epochs=1)), run(FedAvg(cfg, epochs=1))
    curv = run(FedCurv(cfg, epochs=1))
    fs = run(FedSTIL(cfg, n_clients=3, epochs=1))
    assert stl.comm.total == 0 and avg.comm.total > 0
    assert curv.comm.total > 2.5 * avg.comm.total
    assert fs.comm.total_c2s < 1.2 * avg.comm.total_c2s


HOST_ONLY = {"fedcurv": lambda cfg: FedCurv(cfg, epochs=1),
             "fedweit": lambda cfg: FedWeIT(cfg, n_clients=3, epochs=1),
             "ewc": lambda cfg: EWC(cfg, epochs=1),
             "mas": lambda cfg: MAS(cfg, epochs=1),
             "icarl": lambda cfg: ICaRL(cfg, epochs=1,
                                        extractor=EM.extract_prototypes)}


@pytest.mark.parametrize("name", list(HOST_ONLY))
def test_stacked_engine_refuses_host_only_strategies(name):
    _, pb, cfg, _ = _setup()
    s = HOST_ONLY[name](cfg)
    assert not s.supports_stacked
    with pytest.raises(ValueError, match="stacked engine API"):
        run_simulation(s, pb, rounds=1, device="cpu", engine="stacked")


# ---------------------------------------------------------------------------
# the pytree order on integer keys
# ---------------------------------------------------------------------------


def test_int_keys_flatten_in_jax_order():
    """A FedWeIT dispatch's neighbour dicts, keyed by client: the port's
    leaves, paths and bytes in ``jax.tree.flatten``'s order (10 after 2),
    through ``tree_leaves``, ``leaf_paths``, ``tree_bytes`` and the host
    codec's flatten; the nnz dict too."""
    rng = np.random.default_rng(9)
    keys = [10, 2, 0, 11, 1]
    heads = {c: {k: rng.standard_normal(3).astype(np.float32)
                 for k in ("l2.w", "bn.bias", "l10.b", "l1.b")} for c in keys}
    tree = {"neighbors": heads, "neighbors_nnz": {c: np.int64(c) for c in keys}}
    jtree = {"neighbors": {c: theta_to_jax(h) for c, h in heads.items()},
             "neighbors_nnz": tree["neighbors_nnz"]}
    want = jax.tree.leaves(jtree)
    got = PT.tree_leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert [p[1] for p in PT.leaf_paths(tree)][:4] == [0] * 4
    assert [p[1] for p in PT.leaf_paths(tree)][::4][:5] == [0, 1, 2, 10, 11]
    assert PT.tree_bytes(tree) == JPT.tree_bytes(jtree)
    bufs = make_codec("raw").encode(tree).buffers
    jbufs = j_make_codec("raw").encode(jtree).buffers
    assert set(bufs) == set(jbufs)
    for k in jbufs:
        np.testing.assert_array_equal(bufs[k], np.asarray(jbufs[k]))
    back = PT.tree_from_paths(PT.leaf_paths(tree), got)
    assert back["neighbors"][10]["l1.b"] is heads[10]["l1.b"]


def test_string_key_order_is_unchanged():
    """Every flat-key order the port had stays: dotted keys part by part
    (``l10`` after ``l1``, ``l2`` after ``l10`` as strings), the edge head
    in ``bn.bias, bn.scale, head.w, l1.b, l1.w, l2.b, l2.w``, FedSTIL's and
    FedWeIT's trainable trees by their top keys."""
    _, _, cfg, init = _setup()
    head = init["theta0"][0]
    assert [p[0] for p in PT.leaf_paths(head)] == [
        "bn.bias", "bn.scale", "head.w", "l1.b", "l1.w", "l2.b", "l2.w"]
    assert [p[0] for p in PT.leaf_paths({"a.b": 0, "a": 1, "a.a.z": 2,
                                         "l10.w": 3, "l1.w": 4, "l2.w": 5})
            ] == ["a", "a.a.z", "a.b", "l1.w", "l10.w", "l2.w"]
    assert [p[0] for p in PT.leaf_paths(
        {"mask": head, "attn": np.zeros(3), "A": head})][::7] == [
        "A", "attn", "mask"]
    jtree = {"mask": theta_to_jax(head), "attn": np.zeros(3),
             "A": theta_to_jax(head)}
    for g, w in zip(PT.tree_leaves({"mask": head, "attn": np.zeros(3),
                                    "A": head}), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
