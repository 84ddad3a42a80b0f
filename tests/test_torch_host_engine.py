"""The port's host engine (repro_torch: ``run_simulation(engine="host")``,
the relevance tracker, the host aggregation, FedAvg and STL) against the
JAX package (repro) on the same numpy inputs and initial weights, on the
CPU, where the port runs its plain versions.

Tolerances: the tracker's ring and host lists are exact copies; batched
relevance within 1e-5 of the JAX tracker (fp32 KL sums in another order)
and of the port's own loop oracle; the aggregate bases within 1e-6 (the
same fp32 products, R <= 5 terms); the whole host engine within 1e-4 in
every eval round, its byte accounting exactly equal (the bar of
``tests/test_stacked_engine.py``). Rehearsal runs on a bench drawn from a
seed in which no identity has two training samples (ROADMAP Queue 3: the
exemplar order of a two-sample identity is rounding).

The quantized codec (``topk+int8``) keeps the bytes equal per round but
not the metrics at 1e-4: last-bit differences between the packages' heads
flip a few dozen grouped top-k selections from the first residual on (the
mechanism ``test_torch_round.py::test_stateless_topk_selection_flips_are_
last_bit_ties`` pins), and the int8 step then carries each flip's error on.
Measured on these benches: the first payloads quantize to equal codes,
mAP and forgetting stay within 3e-3 and R1 / R5 within 1.5e-2 (one query
of a client's set flips rank). Those runs are held at ``CODED_TOL``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.comm import batched as JBATCHED
from repro.common import pytree as JPT
from repro.core import FedSTIL as JFedSTIL
from repro.core import aggregation as JAGG
from repro.core import edge_model as JEM
from repro.core.relevance import RelevanceTracker as JTracker
from repro.core.similarity import kl_similarity as j_kl_pair
from repro.data import FederatedReIDBenchmark as JBench
from repro.federated import FedAvg as JFedAvg
from repro.federated import run_simulation as j_run
from repro.lifelong import STL as JSTL
from repro.obs import trace as JOBS
from repro_torch.comm import batched as PBATCHED
from repro_torch.common import pytree as PT
from repro_torch.core.adaptive import AdaptiveState, init_adaptive
from repro_torch.core.aggregation import (fedavg_aggregate,
                                          personalized_aggregate)
from repro_torch.core.convert import (init_params_from_jax, theta_from_jax,
                                     theta_to_jax)
from repro_torch.core.fedstil import FedSTIL
from repro_torch.core.relevance import DeviceRingHistory, RelevanceTracker
from repro_torch.core.similarity import SIMILARITY_FNS
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated import FedAvg, run_simulation
from repro_torch.federated.base import Strategy
from repro_torch.lifelong import STL
from repro_torch.obs import trace as POBS

BENCH_KW = dict(n_clients=3, n_tasks=3, n_identities=60, ids_per_task=10,
                samples_per_id=8)
TIE_FREE_SEED = 0          # no identity has two training samples
GUARD_SEED = 1             # tests/test_comm_codec.py's bench
METRICS = ("mAP", "R1", "R5", "forgetting_mAP")
# topk+int8 against the JAX package (module docstring): measured 2.6e-3
# (mAP) / 4.9e-3 (forgetting) / 1.5e-2 (R1, R5) at most
CODED_TOL = {"mAP": 5e-3, "forgetting_mAP": 1e-2, "R1": 2e-2, "R5": 2e-2}


@functools.lru_cache(maxsize=None)
def _setup(seed):
    kw = dict(BENCH_KW, seed=seed)
    jb, pb = JBench(**kw), FederatedReIDBenchmark(**kw)
    cfg = JEM.EdgeModelConfig(n_classes=jb.n_classes)
    g_key, *keys = jax.random.split(jax.random.PRNGKey(0), jb.n_clients + 1)
    init = init_params_from_jax(JEM.init_extraction(g_key, cfg),
                                [JEM.init_adaptive_layers(k, cfg)
                                 for k in keys])
    return jb, pb, cfg, init


def _event_key(e):
    """What a traced run's event says, without its times and values."""
    return (e["kind"], e.get("name"), e.get("cat"), e.get("round"),
            e.get("direction"), e.get("peer"))


def _same_events(jtracer, ptracer):
    """Both packages' traced runs emit the same events in the same order,
    the meta events' fields too (bar the epoch). The host engine emits no
    metric."""
    je, pe = jtracer.events, ptracer.events
    assert [_event_key(e) for e in pe] == [_event_key(e) for e in je]
    strip = lambda e: {k: v for k, v in e.items() if k != "epoch"}
    assert [strip(e) for e in pe if e["kind"] == "meta"] == \
        [strip(e) for e in je if e["kind"] == "meta"]
    assert not any(e["kind"] == "metric" for e in pe)


def _port_run(strategy, bench, init, **kw):
    return run_simulation(strategy, bench, device="cpu", init_params=init,
                          **kw)


def _close(jr, pr, tol):
    """Every eval round's metrics within ``tol`` (a number or a dict by
    metric); returns the largest difference of each metric."""
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


# ---------------------------------------------------------------------------
# the relevance tracker (mirrors tests/test_stacked_engine.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rounds", [1, 3, 9])   # 9 > history_len: overflow
def test_tracker_lists_and_ring_match_jax(n_rounds):
    """Per-client pushes under partial participation: the port's host
    lists equal the JAX tracker's, and a ring fed the same pushes equals
    their stacked history."""
    rng = np.random.default_rng(0)
    C, k, D = 4, 4, 8
    tr, jtr = RelevanceTracker(C, history_len=k), JTracker(C, history_len=k)
    ring = DeviceRingHistory(C, k, D)
    for r in range(n_rounds):
        feats = rng.standard_normal((C, D)).astype(np.float32)
        mask = np.ones((C,), np.float32) if r == 0 else \
            (rng.random(C) < 0.6).astype(np.float32)
        for c in range(C):
            if mask[c] > 0:
                tr.push(c, feats[c])
                jtr.push(c, feats[c])
        ring.push_all(feats, mask)
    dense, valid = tr.stacked_history()
    jdense, jvalid = jtr.stacked_history()
    np.testing.assert_array_equal(dense, jdense)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(ring.buf.numpy(), dense)
    np.testing.assert_array_equal(ring.valid.numpy(), valid)


@pytest.mark.parametrize("metric", ["kl", "cosine", "euclidean"])
def test_tracker_push_all_relevance_matches_jax(metric):
    """push_all keeps ring and lists in sync past overflow; the batched
    relevance (ring-sourced) matches the JAX tracker's and the port's loop
    oracle, whose per-pair KL keeps the reference's 1e-12."""
    rng = np.random.default_rng(2)
    C, k, D = 5, 3, 16
    tr = RelevanceTracker(C, history_len=k, metric=metric)
    jtr = JTracker(C, history_len=k, metric=metric)
    for r in range(k + 2):
        mask = np.ones((C,), np.float32) if r == 0 else \
            (rng.random(C) < 0.7).astype(np.float32)
        feats = np.tanh(rng.standard_normal((C, D))).astype(np.float32)
        tr.push_all(feats, mask)
        jtr.push_all(feats, mask)
        W = tr.relevance()
        np.testing.assert_allclose(W, jtr.relevance(), atol=1e-5)
        np.testing.assert_allclose(tr.relevance(backend="loop"),
                                   jtr.relevance(backend="loop"), atol=1e-5)
        np.testing.assert_allclose(W, tr.relevance(backend="loop"),
                                   atol=1e-5)
        assert not np.diag(W).any()
    assert tr._ring is not None and not tr._ring_dirty


def test_tracker_per_client_push_resyncs_ring():
    """A per-client push dirties the ring; the next push_all rebuilds it
    from the host lists before it goes resident again."""
    rng = np.random.default_rng(3)
    C, k, D = 3, 3, 8
    tr = RelevanceTracker(C, history_len=k)
    tr.push_all(rng.standard_normal((C, D)).astype(np.float32))
    tr.push(1, rng.standard_normal(D).astype(np.float32))
    assert tr._ring_dirty
    np.testing.assert_allclose(tr.relevance(), tr.relevance(backend="loop"),
                               atol=1e-5)
    tr.push_all(rng.standard_normal((C, D)).astype(np.float32))
    dense, valid = tr.stacked_history()
    np.testing.assert_array_equal(tr._ring.buf.numpy(), dense)
    np.testing.assert_array_equal(tr._ring.valid.numpy(), valid)
    np.testing.assert_allclose(tr.relevance(), tr.relevance(backend="loop"),
                               atol=1e-5)
    assert not RelevanceTracker(4).relevance().any()      # no history yet
    with pytest.raises(ValueError, match="'loop'"):
        RelevanceTracker(4, backend="pallas")


def test_pair_kl_similarity_matches_jax():
    """The loop oracle's per-pair KL, with 1e-12 inside the logs."""
    rng = np.random.default_rng(4)
    a, b = (np.tanh(rng.standard_normal((6, 32))).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        SIMILARITY_FNS["kl"](torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_kl_pair(a, b)), atol=1e-6)


# ---------------------------------------------------------------------------
# host aggregation, pytree helpers, the adaptive state
# ---------------------------------------------------------------------------


def _heads(rng, C, cfg):
    return [{k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in theta_from_jax(JEM.init_adaptive_layers(
                 jax.random.PRNGKey(c), cfg), "cpu").items()}
            for c in range(C)]


@pytest.mark.parametrize("rows", [[0, 1, 2, 3, 4], [1, 3], [4]],
                         ids=["R=C", "R=2", "R=1"])
@pytest.mark.parametrize("backend", [None, "loop"])
def test_personalized_aggregate_matches_jax(rows, backend):
    """B = W[rows] @ Θ over five heads, the kernel form and the per-leaf
    einsum against the JAX package's (ref path and loop): within 1e-6,
    each leaf in its shape."""
    cfg = JEM.EdgeModelConfig(n_classes=20)
    rng = np.random.default_rng(5)
    heads = _heads(rng, 5, cfg)
    W = rng.random((5, 5)).astype(np.float32)
    np.fill_diagonal(W, 0.0)
    W /= W.sum(1, keepdims=True)
    port = personalized_aggregate(
        [{k: torch.from_numpy(v) for k, v in h.items()} for h in heads],
        W[rows], backend=backend)
    ref = JAGG.personalized_aggregate([theta_to_jax(h) for h in heads], W[rows],
                                      backend="loop" if backend else "ref")
    assert len(port) == len(ref) == len(rows)
    for p, j in zip(port, ref):
        jflat = theta_from_jax(jax.tree.map(np.asarray, j), "cpu")
        assert set(p) == set(jflat)
        for k, v in p.items():
            assert v.shape == jflat[k].shape and v.is_contiguous()
            np.testing.assert_allclose(v.numpy(), jflat[k].numpy(),
                                       atol=1e-6, err_msg=k)


def test_fedavg_aggregate_and_stack_flatten_match_jax():
    cfg = JEM.EdgeModelConfig(n_classes=20)
    rng = np.random.default_rng(6)
    heads = _heads(rng, 4, cfg)
    theta = [{k: torch.from_numpy(v) for k, v in h.items()} for h in heads]
    mean = fedavg_aggregate(theta)
    jmean = theta_from_jax(jax.tree.map(
        np.asarray, JAGG.fedavg_aggregate([theta_to_jax(h) for h in heads])), "cpu")
    for k, v in mean.items():
        np.testing.assert_allclose(v.numpy(), jmean[k].numpy(), atol=1e-6)
    w = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    jw = theta_from_jax(jax.tree.map(np.asarray, JAGG.fedavg_aggregate(
        [theta_to_jax(h) for h in heads], weights=w)), "cpu")
    for k, v in fedavg_aggregate(theta, weights=w).items():
        np.testing.assert_allclose(v.numpy(), jw[k].numpy(), atol=1e-6)
    mat, meta = PT.tree_stack_flatten(theta)
    jmat, _ = JPT.tree_stack_flatten([theta_to_jax(h) for h in heads])
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    back = PT.tree_unstack_unflatten(mat[1:3], meta)
    assert len(back) == 2
    for k in theta[0]:
        assert torch.equal(back[0][k], theta[1][k])
        assert torch.equal(back[1][k], theta[2][k])
    stacked = PT.tree_stack(theta)
    assert all(torch.equal(a, b) for a, b in zip(
        PT.tree_leaves(PT.tree_unstack(stacked, 4)[3]),
        PT.tree_leaves(theta[3])))


def test_adaptive_state_combines_through_ops():
    rng = np.random.default_rng(7)
    theta0 = {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32))}
    st = init_adaptive(theta0)
    assert torch.equal(st.theta()["w"], theta0["w"])
    t = {"alpha": {"w": torch.full((3, 4), 2.0)},
         "A": {"w": torch.ones((3, 4))}}
    st2 = st.with_trainable(t)
    assert torch.equal(st2.theta()["w"], theta0["w"] * 2.0 + 1.0)
    st3 = st2.with_base({"w": torch.zeros((3, 4))})
    assert isinstance(st3, AdaptiveState)
    assert torch.equal(st3.theta()["w"], torch.ones((3, 4)))
    assert st3.trainable() == t


# ---------------------------------------------------------------------------
# the host engine against the JAX host engine
# ---------------------------------------------------------------------------


STRATEGIES = {
    "fedstil": (JFedSTIL, FedSTIL, {"n_clients": 3}),
    "stl": (JSTL, STL, {}),
    "fedavg": (JFedAvg, FedAvg, {}),
}


@pytest.mark.parametrize("eval_backend", ["device", "host"])
@pytest.mark.parametrize("name", list(STRATEGIES))
def test_host_engine_matches_jax_host_engine(name, eval_backend):
    """run_simulation(engine="host") of both packages, C=3, T=3, epochs 2,
    rounds 4, eval every 2, from the same initial weights: every eval
    round within 1e-4, bytes and storage equal. FedSTIL with rehearsal on;
    its last W within 1e-4."""
    jb, pb, cfg, init = _setup(TIE_FREE_SEED)
    J, P, kw = STRATEGIES[name]
    js, ps = J(cfg, epochs=2, **kw), P(cfg, epochs=2, **kw)
    jt, pt = JOBS.Tracer(), POBS.Tracer()
    jr = j_run(js, jb, rounds=4, eval_every=2, eval_backend=eval_backend,
               trace=jt)
    pr = _port_run(ps, pb, init, rounds=4, eval_every=2, engine="host",
                   eval_backend=eval_backend, trace=pt)
    _close(jr, pr, 1e-4)
    _same_bytes(jr, pr)
    _same_events(jt, pt)
    assert {"local_train", "eval"} <= set(pr.stage_ms[-1])
    if name == "fedstil":
        np.testing.assert_allclose(ps.last_W, js.last_W, atol=1e-4)
        # the host server round has no stage span, as the reference's
        assert "server" in pr.stage_ms[-1]
        assert not any(k.startswith("server.") for k in pr.stage_ms[-1])
    if name == "stl":
        assert pr.comm.total == 0


def test_host_engine_is_the_default_and_runs_the_loop_oracle():
    """``run_simulation`` defaults to the host engine, as the reference;
    ``server_backend="loop"`` (the tracker's per-pair loop, the per-leaf
    einsum aggregate) gives the kernel form's results within 1e-5."""
    _, pb, cfg, init = _setup(TIE_FREE_SEED)
    fast, loop = FedSTIL(cfg, n_clients=3, epochs=1), \
        FedSTIL(cfg, n_clients=3, epochs=1, server_backend="loop")
    rf = _port_run(fast, pb, init, rounds=3, eval_every=3,
                   trace=POBS.Tracer())
    rl = _port_run(loop, pb, init, rounds=3, eval_every=3, engine="host")
    assert "gather" not in rf.stage_ms[0]           # the host loop's stages
    _close(rl, rf, 1e-5)
    np.testing.assert_allclose(fast.last_W, loop.last_W, atol=1e-5)
    assert fast._ring is None and fast.tracker._ring is not None


def test_traced_host_run_with_a_codec_emits_the_jax_events():
    """FedSTIL with ``delta+topk`` on the host engine of both packages,
    traced: the same events (each client's C2S roundtrip inside local
    training, each S2C roundtrip inside the apply), bytes equal, every
    eval round within 1e-4; the codec spans summed per direction in
    ``stage_ms``."""
    jb, pb, cfg, init = _setup(TIE_FREE_SEED)
    kw = dict(n_clients=3, epochs=1, codec="delta+topk")
    jt, pt = JOBS.Tracer(), POBS.Tracer()
    jr = j_run(JFedSTIL(cfg, **kw), jb, rounds=3, eval_every=2, trace=jt)
    pr = _port_run(FedSTIL(cfg, **kw), pb, init, rounds=3, eval_every=2,
                   engine="host", trace=pt)
    _close(jr, pr, 1e-4)
    _same_bytes(jr, pr)
    _same_events(jt, pt)
    peers = [e["peer"] for e in pt.events if e.get("name") == "comm.roundtrip"]
    assert peers[:3] == [["c2s", c] for c in range(3)]
    assert all(r["encode_c2s"] > 0.0 for r in pr.stage_ms)
    total = sum(e["dur"] for e in pt.events
                if e.get("peer", [None])[0] == "s2c") * 1e3
    assert sum(r.get("encode_s2c", 0.0) for r in pr.stage_ms) == \
        pytest.approx(total, rel=1e-12)


# ---------------------------------------------------------------------------
# the host engine against the port's stacked engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_host_matches_stacked_in_the_port(name):
    """Both engines draw the same minibatches: final metrics within 1e-4,
    bytes and storage equal; FedSTIL's last W within 1e-4 and diagonal
    zero (tests/test_stacked_engine.py, on the port)."""
    _, pb, cfg, init = _setup(TIE_FREE_SEED)
    _, P, kw = STRATEGIES[name]
    hs, ss = P(cfg, epochs=2, **kw), P(cfg, epochs=2, **kw)
    host = _port_run(hs, pb, init, rounds=4, eval_every=2, engine="host")
    stacked = _port_run(ss, pb, init, rounds=4, eval_every=2,
                        engine="stacked")
    _close(host, stacked, 1e-4)
    assert host.comm.total_c2s == stacked.comm.total_c2s
    assert host.comm.total_s2c == stacked.comm.total_s2c
    assert host.storage_bytes == stacked.storage_bytes
    if name == "fedstil":
        np.testing.assert_allclose(ss.last_W, hs.last_W, atol=1e-4)
        assert np.allclose(np.diag(ss.last_W), 0.0)


def test_stacked_engine_refuses_a_host_only_strategy():
    _, pb, cfg, _ = _setup(TIE_FREE_SEED)
    with pytest.raises(ValueError, match="stacked engine API"):
        run_simulation(Strategy(cfg, epochs=1), pb, rounds=1, device="cpu",
                       engine="stacked")
    with pytest.raises(ValueError, match="unknown eval_backend"):
        run_simulation(STL(cfg, epochs=1), pb, rounds=1, device="cpu",
                       eval_backend="tpu")


def test_ragged_bench_evaluates_on_the_host_as_jax():
    """A bench whose tasks differ in size cannot be stacked: both packages
    extract task by task and evaluate on the host, whatever
    ``eval_backend`` asks; the port's host engine matches within 1e-4
    (rehearsal off: the trimmed task may leave an identity two samples)."""
    def ragged(bench):
        t = bench._tasks[(1, 0)]
        bench._tasks[(1, 0)] = dataclasses.replace(
            t, train_x=t.train_x[:-5], train_y=t.train_y[:-5],
            query_x=t.query_x[:-3], query_y=t.query_y[:-3])
        return bench
    kw = dict(BENCH_KW, seed=TIE_FREE_SEED)
    jb, pb = ragged(JBench(**kw)), ragged(FederatedReIDBenchmark(**kw))
    _, _, cfg, init = _setup(TIE_FREE_SEED)
    kw = dict(n_clients=3, epochs=1, rehearsal=False)
    jr = j_run(JFedSTIL(cfg, **kw), jb, rounds=3, eval_every=3)
    pr = _port_run(FedSTIL(cfg, **kw), pb, init, rounds=3, eval_every=3,
                   engine="host", eval_backend="device")
    assert not pr.eval_cache.device_ready
    _close(jr, pr, 1e-4)
    _same_bytes(jr, pr)


# ---------------------------------------------------------------------------
# the quantized wire codec on both engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["host", "stacked"])
def test_topk_int8_rounds_match_jax(engine):
    """FedSTIL with ``topk+int8`` (delta on, a dense int8 keyframe per
    stream) on each engine of both packages, C=3, rounds 4: every round's
    wire and formula bytes equal, metrics within ``CODED_TOL``."""
    jb, pb, cfg, init = _setup(TIE_FREE_SEED)
    kw = dict(n_clients=3, epochs=2, codec="topk+int8")
    jr = j_run(JFedSTIL(cfg, **kw), jb, rounds=4, eval_every=2, engine=engine)
    pr = _port_run(FedSTIL(cfg, **kw), pb, init, rounds=4, eval_every=2,
                   engine=engine, trace=POBS.Tracer())
    _close(jr, pr, CODED_TOL)
    _same_bytes(jr, pr)
    assert pr.comm.total < 0.5 * pr.comm.total_formula
    assert {"encode_c2s", "encode_s2c"} <= set(pr.stage_ms[-1])


# (codec, options, strategy) through the stacked round: the dense codecs
# have no top-k, so the packages stay within 1e-4; the sparse bf16 codec
# flips selections as topk+int8 does
QUANT_SPECS = [("int8", {}, "fedstil", 1e-4), ("bf16", {}, "fedstil", 1e-4),
               ("delta+topk+bf16", {}, "fedstil", CODED_TOL),
               ("topk+int8", {"delta": False}, "fedstil", CODED_TOL),
               ("int8", {}, "fedavg", 1e-4)]


@pytest.mark.parametrize("codec,opts,name,tol", QUANT_SPECS,
                         ids=[f"{c}-{o}-{n}" for c, o, n, _ in QUANT_SPECS])
def test_quantized_codecs_run_the_stacked_round_as_jax(codec, opts, name, tol):
    jb, pb, cfg, init = _setup(TIE_FREE_SEED)
    J, P, kw = STRATEGIES[name]
    kw = dict(kw, epochs=1, codec=codec, codec_opts=opts)
    jr = j_run(J(cfg, **kw), jb, rounds=3, eval_every=3, engine="stacked")
    pr = _port_run(P(cfg, **kw), pb, init, rounds=3, eval_every=3,
                   engine="stacked")
    _close(jr, pr, tol)
    _same_bytes(jr, pr)
    assert pr.comm.total < pr.comm.total_formula


def test_int8_keyframes_quantize_to_equal_codes(monkeypatch):
    """Where the coded rounds' drift starts: the packages' keyframes (heads
    equal to ~2e-6) quantize to equal int8 codes, their scales within 2e-6
    relative (the absmax of rows that differ in the last bits); the first
    sparse residual already keeps other elements in some groups (top-k of
    last-bit ties), and the payloads part from there."""
    seen = {"jax": [], "port": []}
    for mod, tag, conv in ((JBATCHED, "jax", np.asarray),
                           (PBATCHED, "port", lambda t: t.numpy())):
        orig = mod.BatchedCodec.roundtrip

        def record(self, mat, _orig=orig, _tag=tag, _conv=conv):
            recon, buf = _orig(self, mat)
            seen[_tag].append({k: _conv(v) for k, v in buf.items()})
            return recon, buf
        monkeypatch.setattr(mod.BatchedCodec, "roundtrip", record)
    jb, pb, cfg, init = _setup(GUARD_SEED)
    kw = dict(n_clients=3, epochs=1, rehearsal=False, codec="topk+int8")
    j_run(JFedSTIL(cfg, **kw), jb, rounds=2, eval_every=2, engine="stacked")
    _port_run(FedSTIL(cfg, **kw), pb, init, rounds=2, eval_every=2,
              engine="stacked")
    (j0, j1, j2, _), (p0, p1, p2, _) = seen["jax"], seen["port"]
    for j, p in ((j0, p0), (j1, p1)):                 # C2S and S2C keyframes
        assert "idx_bits" not in p
        np.testing.assert_array_equal(p["values"], j["values"])
        np.testing.assert_allclose(p["scales"], j["scales"], rtol=2e-6,
                                   atol=0)
    flipped = int((p2["idx_bits"] != j2["idx_bits"]).sum())
    assert 0 < flipped < 0.01 * p2["idx_bits"].size


def test_codec_fidelity_guard_counterpart():
    """``tests/test_comm_codec.py::test_fedstil_codec_fidelity_guard`` on
    the port: its bench and settings (C=3, T=3, 60 ids, seed 1, 6 rounds,
    epochs 3, host engine). The port's coded and uncoded final mAP each
    equal the JAX package's within ``CODED_TOL`` (the bench has two-sample
    identities, so the uncoded run is held there too), and the byte
    asserts stand: coded wire < 0.5x dense FedAvg, every round's C2S wire
    <= its formula. The reference's own 0.03 margin between coded and
    uncoded is not asserted: the reference misses it (0.8108 against
    0.8504, ROADMAP Queue 3), and so does the port."""
    jb, pb, cfg, init = _setup(GUARD_SEED)
    kw = dict(n_clients=3, epochs=3)
    runs = {}
    for codec in (None, "topk+int8"):
        jr = j_run(JFedSTIL(cfg, codec=codec, **kw), jb, rounds=6,
                   eval_every=3)
        pr = _port_run(FedSTIL(cfg, codec=codec, **kw), pb, init, rounds=6,
                       eval_every=3, engine="host")
        assert abs(pr.final("mAP") - jr.final("mAP")) < CODED_TOL["mAP"]
        _same_bytes(jr, pr)
        runs[codec] = pr
    avg = _port_run(FedAvg(cfg, epochs=3), pb, init, rounds=6, eval_every=3,
                    engine="host")
    coded = runs["topk+int8"]
    assert coded.comm.measured
    assert coded.comm.total < 0.5 * avg.comm.total
    assert coded.comm.total < coded.comm.total_formula
    rows = coded.comm_breakdown()
    assert rows and all(r["c2s_wire"] <= r["c2s_formula"] for r in rows)


def test_host_wire_hooks_keep_devices_and_dtypes():
    """The host codec's decoded payload comes back as tensors on the
    payload's device in their own dtypes; the verbatim task feature
    counts in the measured bytes."""
    _, _, cfg, init = _setup(TIE_FREE_SEED)
    st = FedSTIL(cfg, n_clients=3, codec="int8")
    theta = {k: torch.from_numpy(v) for k, v in init["theta0"][0].items()}
    feat = np.ones((cfg.proto_dim,), np.float32)
    out, measured = st.wire_upload({"theta": theta, "task_feature": feat}, 0)
    P = sum(v.numel() for v in theta.values())
    step = max(float(v.abs().max()) for v in theta.values()) / 127
    assert measured == P + 4 * (-(-P // 256)) + feat.nbytes
    assert out["task_feature"] is feat
    for k, v in out["theta"].items():
        assert isinstance(v, torch.Tensor) and v.dtype == theta[k].dtype
        assert v.shape == theta[k].shape
        np.testing.assert_allclose(v.numpy(), theta[k].numpy(), atol=step)
    out, measured = st.wire_dispatch({"B": theta}, 2)
    assert measured == P + 4 * (-(-P // 256))
    assert set(out) == {"B"}
