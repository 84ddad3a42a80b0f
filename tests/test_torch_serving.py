"""The port's serving path (repro_torch.serving) against the JAX package's
(repro.serving) on the same numpy galleries, queries and stacked heads, on
the CPU (the port's plain versions; the JAX package's jnp ref path and its
Pallas kernels in interpret mode).

Tolerances: refresh features / BN statistics / norms atol 1e-5, scales
rtol 1e-5, int8 codes equal except a fraction <= 1e-4 off by one (matmul
ulps at a rounding boundary); query ids equal, distances atol 1e-5; the
fp32 path equals the port's numpy oracle id for id.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import edge_model as JEM
from repro.data import FederatedReIDBenchmark as JBench
from repro.federated.simulation import _EvalCache as JEvalCache
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import GalleryIndex as JIndex
from repro.serving import RetrievalEngine as JEngine
from repro.serving import map_from_ranked_ids as j_map
from repro.serving import recall_at_k as j_recall
from repro.serving.engine import _rank_topk as j_rank_topk
from repro.serving.index import index_refresh_program
from repro.serving.index import refresh_host as j_refresh_host
from repro.obs.metrics import LatencyHistogram as JHistogram
from repro_torch.core.convert import theta_from_jax
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated.simulation import _EvalCache as EvalCache
from repro_torch.launch import serve as serve_cli
from repro_torch.obs.metrics import LatencyHistogram, ServeStats
from repro_torch.serving import (ContinuousBatcher, GalleryIndex,
                                 RetrievalEngine, map_from_ranked_ids,
                                 recall_at_k, run_open_loop)
from repro_torch.serving.engine import rank_topk
from repro_torch.serving.index import index_refresh, refresh_host

CFG = JEM.EdgeModelConfig()
BACKENDS = ["ref", "interpret"]


def _jax_heads(C, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    thetas = [JEM.init_adaptive_layers(k, CFG) for k in keys]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *thetas)


def _galleries(C=3, G=40, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    sizes = [G - 5 * c if ragged else G for c in range(C)]
    protos = [rng.standard_normal((n, CFG.proto_dim)).astype(np.float32)
              for n in sizes]
    ids = [rng.integers(0, 12, n).astype(np.int32) for n in sizes]
    return protos, ids, rng


def _queries(C, B, seed):
    rng = np.random.default_rng(seed)
    qp = rng.standard_normal((C, B, CFG.proto_dim)).astype(np.float32)
    qmask = np.ones((C, B), np.float32)
    qmask[0, B - 2:] = 0.0                      # padded slots come back -1
    return qp, qmask


@pytest.fixture(scope="module")
def served():
    protos, ids, _ = _galleries()
    theta_np = _jax_heads(3)
    index = GalleryIndex(protos, ids, capacity=40, device="cpu")
    eng8 = RetrievalEngine(index, theta_from_jax(theta_np, "cpu"), k=5,
                           mode="int8")
    engf = RetrievalEngine(index, eng8.theta, k=5, mode="fp32",
                           refresh=False)
    return types.SimpleNamespace(protos=protos, ids=ids, theta_np=theta_np,
                                 index=index, eng8=eng8, engf=engf)


def _assert_refresh_close(got, want):
    tq, ts, tn2, tmu, tsd, tf = got
    jq, js, jn2, jmu, jsd, jf = (np.asarray(a) for a in want)
    diff = tq.astype(np.int32) - jq.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 1e-4
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    for a, b in ((tn2, jn2), (tmu, jmu), (tsd, jsd), (tf, jf)):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_matches_jax(served, backend):
    ix = served.index
    gmask = (ix.gids_host >= 0).astype(np.float32)
    want = index_refresh_program(served.theta_np, ix.gp, gmask,
                                 backend=backend)
    got = [t.numpy() for t in index_refresh(served.eng8.theta,
                                            torch.from_numpy(ix.gp),
                                            torch.from_numpy(gmask))]
    _assert_refresh_close(got, want)
    # the resident image is that refresh; empty slots: codes 0, scale 1,
    # norm 0
    np.testing.assert_array_equal(ix.gq.numpy(), got[0])
    empty = ix.gids_host < 0
    assert empty.any()
    assert np.all(ix.gq.numpy()[empty] == 0)
    assert np.all(ix.gscale.numpy()[empty] == 1.0)
    assert np.all(ix.gn2.numpy()[empty] == 0.0)


def test_refresh_host_copy_matches_jax_oracle_and_refresh(served):
    ix = served.index
    gmask = (ix.gids_host >= 0).astype(np.float32)
    host = refresh_host(served.eng8.theta, ix.gp, gmask)
    for a, b in zip(host, j_refresh_host(served.theta_np, ix.gp, gmask)):
        np.testing.assert_array_equal(a, b)
    _assert_refresh_close(
        (ix.gq.numpy(), ix.gscale.numpy(), ix.gn2.numpy(), ix.bn_mu.numpy(),
         ix.bn_sd.numpy(), ix.gf.numpy()), host)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["int8", "fp32"])
def test_query_batch_matches_jax(served, mode, backend):
    jindex = JIndex(served.protos, served.ids, capacity=40, backend=backend)
    jeng = JEngine(jindex, served.theta_np, k=5, mode=mode, backend=backend)
    eng = served.eng8 if mode == "int8" else served.engf
    qp, qmask = _queries(3, 7, seed=11)
    ids_t, d_t = eng.query_batch(qp, qmask)
    ids_j, d_j = jeng.query_batch(qp, qmask)
    np.testing.assert_array_equal(ids_t, ids_j)
    valid = qmask > 0
    np.testing.assert_allclose(d_t[valid], d_j[valid], atol=1e-5)
    assert np.all(ids_t[~valid] == -1)


def test_fp32_rank_parity_with_host_oracle(served):
    qp, qmask = _queries(3, 9, seed=12)
    ids_d, dist_d = served.engf.query_batch(qp, qmask)
    ids_h, dist_h = served.engf.query_host(qp, qmask)
    np.testing.assert_array_equal(ids_d, ids_h)
    np.testing.assert_allclose(dist_d[qmask > 0], dist_h[qmask > 0],
                               atol=1e-5)


def test_rank_topk_ties_like_lax_top_k():
    """Exact ties resolve to the lowest gallery index, as lax.top_k does;
    empty slots rank last, masked query slots return -1."""
    rng = np.random.default_rng(5)
    dist = rng.integers(0, 4, (2, 3, 12)).astype(np.float32)
    gids = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    gids[1, ::3] = -1
    qmask = np.ones((2, 3), np.float32)
    qmask[1, 2] = 0.0
    ids_t, d_t = rank_topk(*map(torch.from_numpy, (dist, gids, qmask)), 9)
    ids_j, d_j = j_rank_topk(dist, gids, qmask, 9)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("mode", ["int8", "fp32"])
def test_duplicate_rows_rank_lowest_index_first(mode):
    rng = np.random.default_rng(6)
    protos = rng.standard_normal((30, CFG.proto_dim)).astype(np.float32)
    dup = (4, 11, 23)
    protos[list(dup)] = protos[17]
    index = GalleryIndex([protos], [np.arange(30, dtype=np.int32)],
                         device="cpu")
    eng = RetrievalEngine(index, theta_from_jax(_jax_heads(1), "cpu"), k=4,
                          mode=mode)
    ids, d = eng.query_batch(protos[17][None, None], np.ones((1, 1)))
    assert list(ids[0, 0]) == [4, 11, 17, 23]
    assert d[0, 0, 0] == d[0, 0, 1] == d[0, 0, 2] == d[0, 0, 3]


def test_batch_composition_invariance(served):
    eng8 = served.eng8
    rng = np.random.default_rng(13)
    probe = rng.standard_normal(CFG.proto_dim).astype(np.float32)
    qp1 = np.zeros((3, 1, CFG.proto_dim), np.float32)
    qp1[1, 0] = probe
    m1 = np.zeros((3, 1), np.float32)
    m1[1, 0] = 1.0
    ids1, d1 = eng8.query_batch(qp1, m1)
    qp8 = rng.standard_normal((3, 8, CFG.proto_dim)).astype(np.float32)
    qp8[1, 3] = probe
    ids8, d8 = eng8.query_batch(qp8, np.ones((3, 8), np.float32))
    np.testing.assert_array_equal(ids1[1, 0], ids8[1, 3])
    np.testing.assert_allclose(d1[1, 0], d8[1, 3], atol=1e-5)


def test_update_equals_fresh_engine(served):
    def fresh(theta):
        protos, ids, _ = _galleries()
        return RetrievalEngine(GalleryIndex(protos, ids, capacity=40,
                                            device="cpu"), theta, k=5)

    eng = fresh(served.eng8.theta)
    old_gq = eng.index.gq.clone()
    theta2 = theta_from_jax(_jax_heads(3, seed=9), "cpu")
    eng.update(theta2)
    assert not torch.equal(old_gq, eng.index.gq)
    ref = fresh(theta2)
    assert torch.equal(eng.index.gq, ref.index.gq)
    qp, qmask = _queries(3, 3, seed=14)
    np.testing.assert_array_equal(eng.query_batch(qp, qmask)[0],
                                  ref.query_batch(qp, qmask)[0])


def test_extend_appends_rows():
    protos, ids, rng = _galleries(C=2, G=20, ragged=False)
    ids = [y.copy() for y in ids]
    index = GalleryIndex([p[:15] for p in protos], [y[:15] for y in ids],
                         capacity=20, device="cpu")
    eng = RetrievalEngine(index, theta_from_jax(_jax_heads(2), "cpu"), k=3,
                          mode="fp32")
    new_p = rng.standard_normal((4, CFG.proto_dim)).astype(np.float32)
    eng.extend(0, new_p, np.full(4, 99, np.int32))
    assert index.fill == [19, 15]
    assert torch.equal(index.gp_dev, torch.from_numpy(index.gp))
    qp = np.zeros((2, 1, CFG.proto_dim), np.float32)
    qp[0, 0] = new_p[2]
    found, _ = eng.query_batch(qp, np.ones((2, 1), np.float32))
    assert 99 in found[0, 0]
    with pytest.raises(ValueError, match="exceed capacity"):
        eng.extend(0, rng.standard_normal((5, CFG.proto_dim)), np.arange(5))


@pytest.mark.parametrize("policy", ["fifo", "drr"])
def test_batcher_coalesces_and_matches_direct(served, policy):
    """Tickets drain oldest first and return exactly what a direct
    query_batch returns, under both admission policies."""
    eng8 = served.eng8
    stats = ServeStats()
    b = ContinuousBatcher(eng8, batch=4, policy=policy, stats=stats,
                          step_budget=6 if policy == "drr" else None)
    rng = np.random.default_rng(15)
    protos = rng.standard_normal((12, CFG.proto_dim)).astype(np.float32)
    tickets = [b.submit(1 if i < 9 else 2, protos[i], qid=i)
               for i in range(12)]
    first = b.step()
    assert [t.qid for t in first if t.client == 1] == [0, 1, 2, 3]
    rest = b.drain()
    assert len(first) + len(rest) == 12 and b.pending == 0
    assert stats.snapshot()["completed"] == 12
    for t, p in zip(tickets, protos):
        qp = np.zeros((3, 1, CFG.proto_dim), np.float32)
        qp[t.client, 0] = p
        m = np.zeros((3, 1), np.float32)
        m[t.client, 0] = 1.0
        ids, _ = eng8.query_batch(qp, m)
        np.testing.assert_array_equal(t.ids, ids[t.client, 0])
        assert t.t_done >= t.t_launch >= t.t_submit


@pytest.mark.parametrize("policy,budget", [("fifo", None), ("fifo", 5),
                                           ("drr", 5)])
def test_batcher_admission_matches_jax(policy, budget):
    """Same submissions, same launches: the port's batcher copy admits
    exactly the queries the JAX package's batcher admits, step by step."""
    def engine():
        index = types.SimpleNamespace(n_clients=3, gp=np.zeros((3, 1, 4)))
        return types.SimpleNamespace(
            index=index, query_batch=lambda qp, qm: (
                np.zeros(qm.shape + (2,), np.int32),
                np.zeros(qm.shape + (2,), np.float32)))

    batchers = [cls(engine(), batch=3, policy=policy, step_budget=budget)
                for cls in (ContinuousBatcher, JBatcher)]
    rng = np.random.default_rng(16)
    for i, c in enumerate(rng.choice(3, 20, p=[0.6, 0.3, 0.1])):
        for b in batchers:
            b.submit(int(c), np.zeros(4, np.float32), qid=i, now=0.0)
    while batchers[1].pending:
        steps = [[(t.client, t.qid) for t in b.step()] for b in batchers]
        assert steps[0] == steps[1]
    assert batchers[0].pending == 0


def test_open_loop_answers_every_paced_query(served):
    rng = np.random.default_rng(18)
    stream = [(int(c), rng.standard_normal(CFG.proto_dim).astype(np.float32),
               i) for i, c in enumerate(rng.integers(0, 3, 12))]
    r = run_open_loop(ContinuousBatcher(served.eng8, batch=4), stream,
                      rate_qps=2000.0)
    assert r["n"] == 12 and sorted(t.qid for t in r["tickets"]) == list(
        range(12))
    assert all(t.queue_s >= 0 and t.service_s > 0 for t in r["tickets"])


def test_latency_histogram_matches_jax():
    samples = np.random.default_rng(19).lognormal(-6, 1.5, 500)
    ours, theirs = LatencyHistogram(), JHistogram()
    ours.record_many(samples)
    theirs.record_many(samples)
    np.testing.assert_array_equal(ours.counts, theirs.counts)
    for q in (50, 90, 99):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.snapshot() == theirs.snapshot()


def test_int8_map_delta_bounded():
    protos, ids, rng = _galleries(C=4, G=60, seed=3)
    index = GalleryIndex(protos, ids, capacity=60, device="cpu")
    theta = theta_from_jax(_jax_heads(4, seed=3), "cpu")
    eng8 = RetrievalEngine(index, theta, mode="int8")
    engf = RetrievalEngine(index, theta, mode="fp32", refresh=False)
    qp = rng.standard_normal((4, 10, CFG.proto_dim)).astype(np.float32)
    qmask = np.ones((4, 10), np.float32)
    qids = rng.integers(0, 12, (4, 10))
    ids8, _ = eng8.query_batch(qp, qmask, k=60)
    idsf, _ = engf.query_batch(qp, qmask, k=60)
    m8 = np.mean([map_from_ranked_ids(ids8[c], qids[c]) for c in range(4)])
    mf = np.mean([map_from_ranked_ids(idsf[c], qids[c]) for c in range(4)])
    assert mf > 0.0
    assert abs(m8 - mf) <= 0.01


def test_map_and_recall_match_jax():
    ids = np.array([[7, 2, 7, 3], [1, 2, 3, 4]])
    assert map_from_ranked_ids(ids, np.array([7, 9])) == pytest.approx(5 / 6)
    assert map_from_ranked_ids(ids, np.array([7, 1]),
                               qmask=np.array([1.0, 0.0])) == pytest.approx(
                                   5 / 6)
    rng = np.random.default_rng(17)
    ranked = rng.integers(-1, 6, (5, 9))
    qids = rng.integers(0, 8, 5)
    qmask = np.array([1, 1, 0, 1, 1], np.float32)
    assert map_from_ranked_ids(ranked, qids, qmask) == j_map(ranked, qids,
                                                             qmask)
    approx, exact = rng.integers(-1, 9, (2, 5, 4)), rng.integers(-1, 9, (2, 5, 4))
    assert recall_at_k(approx, exact) == j_recall(approx, exact)


def test_cuda_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    protos, ids, _ = _galleries(C=1, G=8)
    with pytest.raises(RuntimeError, match="cuda"):
        GalleryIndex(protos, ids)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--gallery", "8", "--queries", "2"])


def test_ivf_builds_and_answers():
    """nlist > 0 builds the IVF image and mode="ivf" answers; a full probe
    returns the exact int8 answers (tests/test_torch_serving_ivf.py holds
    the IVF path to the JAX package)."""
    protos, ids, _ = _galleries(C=2, G=24)
    index = GalleryIndex(protos, ids, nlist=4, device="cpu")
    assert index.bcap == 32 and index.nlist * index.bcap >= index.capacity
    theta = theta_from_jax(_jax_heads(2), "cpu")
    engv = RetrievalEngine(index, theta, k=5, mode="ivf", nprobe=4)
    assert index.has_ivf and engv.nprobe == 4
    eng8 = RetrievalEngine(index, theta, k=5, mode="int8", refresh=False)
    qp, qmask = _queries(2, 4, seed=20)
    ids_v, d_v = engv.query_batch(qp, qmask)
    ids_8, d_8 = eng8.query_batch(qp, qmask)
    np.testing.assert_array_equal(ids_v, ids_8)
    valid = qmask > 0
    np.testing.assert_allclose(d_v[valid], d_8[valid], atol=1e-5)


def test_query_naive_matches_jax_and_the_batched_path(served):
    """The per-query fp32 baseline, on the plain 2-D distance in both
    packages: ids equal, distances 1e-5; and the batched fp32 answer."""
    jindex = JIndex(served.protos, served.ids, capacity=40, backend="ref")
    jeng = JEngine(jindex, served.theta_np, k=5, mode="fp32", backend="ref")
    qp, qmask = _queries(3, 4, seed=22)
    ids_b, d_b = served.engf.query_batch(qp, np.ones_like(qmask))
    for c in range(3):
        for b in range(4):
            ids_t, d_t = served.engf.query_naive(c, qp[c, b])
            ids_j, d_j = jeng.query_naive(c, qp[c, b])
            np.testing.assert_array_equal(ids_t, ids_j)
            np.testing.assert_allclose(d_t, d_j, atol=1e-5)
            np.testing.assert_array_equal(ids_t, ids_b[c, b])
            np.testing.assert_allclose(d_t, d_b[c, b], atol=1e-5)
    with pytest.raises(ValueError, match="keep_fp32"):
        RetrievalEngine(GalleryIndex(served.protos, served.ids, keep_fp32=False,
                                     device="cpu"),
                        served.eng8.theta).query_naive(0, qp[0, 0])


@pytest.mark.parametrize("mode", ["int8", "fp32"])
def test_from_eval_cache_matches_jax(mode):
    """Serving a simulation's evaluation galleries (the eval cache's
    per-client assembly of the other clients' query splits of tasks <= t):
    the same galleries and the same answers as the JAX package's."""
    kw = dict(n_clients=3, n_tasks=2, n_identities=40, ids_per_task=8,
              samples_per_id=6)
    bench, jbench = FederatedReIDBenchmark(**kw), JBench(**kw)
    rng = np.random.default_rng(21)
    protos = {}
    for c in range(3):
        for t in range(2):
            task = bench.task(c, t)
            protos[(c, t)] = (
                rng.standard_normal((len(task.train_y), CFG.proto_dim)
                                    ).astype(np.float32), task.train_y,
                rng.standard_normal((len(task.query_y), CFG.proto_dim)
                                    ).astype(np.float32), task.query_y)
    theta_np = _jax_heads(3, seed=4)
    eng = RetrievalEngine.from_eval_cache(
        theta_from_jax(theta_np, "cpu"), EvalCache(bench, protos, "cpu"), 1,
        k=5, mode=mode, device="cpu")
    jeng = JEngine.from_eval_cache(theta_np, JEvalCache(jbench, protos,
                                                        device=False), 1,
                                   k=5, mode=mode, backend="ref")
    np.testing.assert_array_equal(eng.index.gids_host, jeng.index.gids_host)
    np.testing.assert_array_equal(eng.index.gp, jeng.index.gp)
    qp = np.stack([protos[(c, 1)][2] for c in range(3)])
    qmask = np.ones(qp.shape[:2], np.float32)
    ids_t, d_t = eng.query_batch(qp, qmask)
    ids_j, d_j = jeng.query_batch(qp, qmask)
    np.testing.assert_allclose(d_t, d_j, atol=1e-5)
    # ids equal, except that two rows whose distances lie within the fp32
    # sum-order error (here 6e-7 apart) may swap ranks
    for c, b, r in np.argwhere(ids_t != ids_j):
        (pos,) = np.nonzero(ids_t[c, b] == ids_j[c, b, r])
        assert len(pos) and abs(d_t[c, b, pos[0]] - d_j[c, b, r]) <= 1e-5
    assert (ids_t != ids_j).mean() <= 0.01


@pytest.mark.parametrize("mode", ["int8", "fp32"])
def test_serve_launcher_runs_on_cpu(mode, capsys):
    out = serve_cli.main(["--device", "cpu", "--clients", "2", "--gallery",
                          "64", "--queries", "16", "--batch", "4", "--mode",
                          mode])
    assert out["pre"]["n"] == 8 and out["post"]["n"] == 8
    assert all(t.ids.shape == (10,) for t in out["post"]["tickets"])
    assert "post-update: 8 queries" in capsys.readouterr().out
