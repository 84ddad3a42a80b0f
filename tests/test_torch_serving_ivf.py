"""The port's IVF shortlist serving path (repro_torch.serving, mode="ivf")
against the JAX package's (repro.serving) on the same numpy galleries,
queries and stacked heads, on the CPU: the port's plain versions against the
JAX package's jnp ``ref`` path and its Pallas kernels in interpret mode.

Fixture: the reference's own (tests/test_serving_ivf.py): C = 3 clients of
G = 256 clustered rows, nlist 16, bcap 32, 4 Lloyd iterations.

Tolerances, each with its reason:
  * probe ids equal (ties to the lowest bucket id in both packages);
    coarse distances atol = rtol = 1e-5 (fp32 sums over F in another order);
  * shortlist partial distances atol 1e-4, rtol 1e-5: int8 codes up to 127
    against standard-normal queries make |d| reach ~1e3, where 1e-5
    relative is the fp32 sum-order error; ids equal;
  * the IVF refresh: int8 codes within +-1 on at most 1e-4 of entries
    (matmul ulps at a rounding boundary, ROADMAP Queue 3), centroids
    atol 2e-3 and rtol 1e-3 (the reference's own bar against its numpy
    oracle), bucket lists equal on this fixture (where the reference's two
    builds agree exactly);
  * served ids equal and distances atol 1e-5 when both packages query the
    same image.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import edge_model as JEM
from repro.kernels import ops as JOPS
from repro.obs.metrics import ivf_metrics as j_ivf_metrics
from repro.serving import GalleryIndex as JIndex
from repro.serving import RetrievalEngine as JEngine
from repro.serving.engine import query_ivf_host as j_query_ivf_host
from repro.serving.engine import query_ivf_program
from repro.serving.index import index_refresh_ivf_program
from repro.serving.index import ivf_refresh_host as j_ivf_refresh_host
from repro_torch.core.convert import theta_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as serve_cli
from repro_torch.obs.metrics import ivf_metrics
from repro_torch.serving import (ContinuousBatcher, GalleryIndex,
                                 RetrievalEngine, query_ivf, query_ivf_host,
                                 recall_at_k)
from repro_torch.serving.engine import featurize, rank_shortlist
from repro_torch.serving.index import index_refresh_ivf, ivf_refresh_host

CFG = JEM.EdgeModelConfig()
BACKENDS = ["ref", "interpret"]
IVF = dict(nlist=16, bcap=32, ivf_iters=4)


def _l2n(x):
    return x / np.sqrt(np.maximum((x * x).sum(-1, keepdims=True), 1e-12))


def _jax_heads(C, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    thetas = [JEM.init_adaptive_layers(k, CFG) for k in keys]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *thetas)


def _clustered(rng, n, *, rank=8, rho=0.25, n_per=8):
    U, _ = np.linalg.qr(rng.standard_normal((CFG.proto_dim, rank)))
    centers = _l2n(_l2n(rng.standard_normal((n // n_per, rank))
                        ).astype(np.float32) @ U.T.astype(np.float32))
    idx = np.repeat(np.arange(n // n_per), n_per)
    noise = _l2n(rng.standard_normal((n, CFG.proto_dim))).astype(np.float32)
    return (_l2n(centers[idx] + rho * noise).astype(np.float32),
            centers.astype(np.float32))


def _fixture_data(C=3, G=256, seed=0):
    rng = np.random.default_rng(seed)
    protos, centers = zip(*(_clustered(rng, G) for _ in range(C)))
    ids = [np.arange(G, dtype=np.int32) for _ in range(C)]
    return list(protos), ids, list(centers), rng


def _queries(rng, centers, B, rho=0.25):
    qp = np.stack([
        _l2n(c[rng.integers(0, len(c), B)]
             + rho * _l2n(rng.standard_normal((B, CFG.proto_dim))))
        for c in centers]).astype(np.float32)
    return qp, np.ones((len(centers), B), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ivf():
    protos, ids, centers, rng = _fixture_data()
    theta_np = _jax_heads(len(protos))
    index = GalleryIndex(protos, ids, device="cpu", **IVF)
    theta = theta_from_jax(theta_np, "cpu")
    eng8 = RetrievalEngine(index, theta, k=10, mode="int8")
    engv = RetrievalEngine(index, theta, k=10, mode="ivf", nprobe=4,
                           refresh=False)
    gmask = (index.gids_host >= 0).astype(np.float32)
    jout = index_refresh_ivf_program(
        theta_np, index.gp, gmask, index.gids_host, nlist=index.nlist,
        bcap=index.bcap, iters=index.ivf_iters,
        train_cap=index.ivf_train_cap, balance=index.ivf_balance,
        backend="ref")
    return types.SimpleNamespace(
        protos=protos, ids=ids, centers=centers, rng=rng, theta_np=theta_np,
        theta=theta, index=index, eng8=eng8, engv=engv, gmask=gmask,
        jout=[np.asarray(a) for a in jout])


# ---------------------------------------------------------------------------
# plain versions of the two kernels against the JAX dispatchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("C,B,F,L", [(2, 5, 32, 7), (1, 1, 64, 3),
                                     (3, 70, 64, 130)])
def test_cluster_assign_matches_jax(C, B, F, L, backend):
    """Probe ids equal to the JAX dispatcher's (ragged B and L); the plain
    coarse distances equal the JAX ref's."""
    rng = np.random.default_rng(1)
    qf = rng.standard_normal((C, B, F)).astype(np.float32)
    cent = rng.standard_normal((C, L, F)).astype(np.float32)
    cn2 = (cent * cent).sum(-1)
    nprobe = min(3, L)
    got = ops.batched_cluster_assign(_t(qf), _t(cent), _t(cn2), nprobe=nprobe)
    want = JOPS.batched_cluster_assign(qf, cent, cn2, nprobe=nprobe,
                                       backend=backend)
    assert got.dtype == torch.int32 and got.shape == (C, B, nprobe)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = qf.astype(np.float32)
    dc_j = ((q * q).sum(-1)[..., None] + cn2[:, None, :]
            - 2.0 * np.einsum("cbf,clf->cbl", q, cent))
    np.testing.assert_allclose(
        ref.batched_cluster_dist_ref(_t(qf), _t(cent), _t(cn2)).numpy(),
        dc_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cluster_assign_ties_go_to_lowest_bucket(backend):
    """Duplicated centroids tie exactly: both packages pick the lowest ids
    first, in order (lax.top_k's rule; torch.topk promises none)."""
    rng = np.random.default_rng(2)
    C, B, F, L = 2, 6, 16, 12
    cent = rng.standard_normal((C, L, F)).astype(np.float32)
    cent[:, [3, 7, 10]] = cent[:, 5:6]          # four equal centroids
    cent[1] = 0.0                               # a client of all-equal ones
    cn2 = (cent * cent).sum(-1)
    qf = np.repeat(cent[:, 5:6], B, axis=1)     # queries on the tie
    qf[:, 1:] += 0.01 * rng.standard_normal((C, B - 1, F)).astype(np.float32)
    got = ops.batched_cluster_assign(_t(qf), _t(cent), _t(cn2), nprobe=6)
    want = JOPS.batched_cluster_assign(qf, cent, cn2, nprobe=6,
                                       backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert list(got[0, 0, :4].numpy()) == [3, 5, 7, 10]
    assert list(got[1, 0].numpy()) == [0, 1, 2, 3, 4, 5]


def _bucket_image(rng, C, L, K, F):
    """A bucket-major image with a partial bucket, a whole empty bucket and
    an all-empty client (the reference test's recipe)."""
    bids = rng.integers(0, 999, (C, L, K)).astype(np.int32)
    bids[0, 2, 3:] = -1
    bids[1, 4] = -1
    bids[2] = -1
    bq = rng.integers(-127, 128, (C, L, K, F)).astype(np.int8)
    bq = np.where(bids[..., None] >= 0, bq, 0).astype(np.int8)
    scale = np.where(bids >= 0, 0.001 + rng.random((C, L, K)),
                     1.0).astype(np.float32)
    n2 = np.where(bids >= 0, rng.random((C, L, K)), 0.0).astype(np.float32)
    pack = np.stack([scale, n2, bids.view(np.float32)], axis=2)
    return bq, pack, bids


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("B,P", [(4, 3), (7, 6)])
def test_shortlist_matches_jax(B, P, backend):
    rng = np.random.default_rng(3)
    C, F, L, K = 3, 32, 6, 5
    qf = rng.standard_normal((C, B, F)).astype(np.float32)
    bq, pack, bids = _bucket_image(rng, C, L, K, F)
    probe = rng.integers(0, L, (C, B, P)).astype(np.int32)
    probe[1, 0, 0] = 4                                   # the empty bucket
    d, ids = ops.batched_ivf_shortlist(_t(qf), _t(probe), _t(bq), _t(pack))
    dj, idj = JOPS.batched_ivf_shortlist(qf, probe, bq, pack,
                                         backend=backend)
    assert d.shape == ids.shape == (C, B, P * K) and ids.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(idj))
    want_ids = np.stack([bids[c][probe[c]].reshape(B, P * K)
                         for c in range(C)])
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert np.all(ids.numpy()[2] == -1) and np.all(d.numpy()[2] == 0.0)
    # the kernel's plain version is the same scores before flattening
    d4, ids4 = ref.batched_ivf_shortlist_scores_ref(_t(qf), _t(probe),
                                                    _t(bq), _t(pack))
    assert d4.shape == (C, B, P, K)
    assert torch.equal(d4.reshape(C, B, -1), d)
    assert torch.equal(ids4.reshape(C, B, -1), ids)


# ---------------------------------------------------------------------------
# the IVF refresh against the JAX builds
# ---------------------------------------------------------------------------


def test_ivf_refresh_matches_jax(ivf):
    """The port's build against ``index_refresh_ivf_program(backend="ref")``
    on the reference fixture."""
    ix = ivf.index
    jq, js, jn2, jmu, jsd, jf, jcent, jcn2, jbq, jpack, jbinv = ivf.jout
    diff = ix.gq.numpy().astype(np.int32) - jq.astype(np.int32)
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-4
    np.testing.assert_allclose(ix.gscale.numpy(), js, rtol=1e-5)
    np.testing.assert_allclose(ix.cent.numpy(), jcent, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(ix.cn2.numpy(), jcn2, atol=5e-3)
    np.testing.assert_array_equal(ix.binv.numpy(), jbinv)
    G = ix.capacity
    binv = ix.binv.numpy()
    for c in range(ix.n_clients):
        placed = binv[c][binv[c] >= 0]
        assert len(placed) == G and len(np.unique(placed)) == G
    # the bucket-major image is the flat image gathered by binv
    present = binv >= 0
    safe = np.maximum(binv, 0)
    for c in range(ix.n_clients):
        np.testing.assert_array_equal(
            ix.bq.numpy()[c], np.where(present[c][..., None],
                                       ix.gq.numpy()[c][safe[c]], 0))
        pk = ix.pack.numpy()[c]
        np.testing.assert_array_equal(
            pk[:, 0], np.where(present[c], ix.gscale.numpy()[c][safe[c]], 1.0))
        np.testing.assert_array_equal(
            pk[:, 1], np.where(present[c], ix.gn2.numpy()[c][safe[c]], 0.0))
        np.testing.assert_array_equal(
            pk[:, 2].view(np.int32),
            np.where(present[c], ix.gids_host[c][safe[c]], -1))
    assert ix.has_ivf and ix.binv.dtype == torch.int32


def test_flat_codes_match_the_jitted_build_bit_for_bit(ivf):
    """Which JAX build the port's flat int8 codes equal: the jitted one
    (same fp32 feature math, same quantizer product), where the numpy
    oracle differs in 2 codes at rounding boundaries (ROADMAP: the red
    reference test)."""
    jq = ivf.jout[0]
    hq = j_ivf_refresh_host(ivf.theta_np, ivf.index.gp, ivf.gmask,
                            ivf.index.gids_host, nlist=16, bcap=32, iters=4,
                            train_cap=ivf.index.ivf_train_cap,
                            balance=0.1)[0]
    gq = ivf.index.gq.numpy()
    assert np.array_equal(gq, jq)
    assert int((gq != hq).sum()) == 2


def test_ivf_refresh_host_copy_matches_jax(ivf):
    ix = ivf.index
    kw = dict(nlist=ix.nlist, bcap=ix.bcap, iters=ix.ivf_iters,
              train_cap=ix.ivf_train_cap, balance=ix.ivf_balance)
    got = ivf_refresh_host(ivf.theta, ix.gp, ivf.gmask, ix.gids_host, **kw)
    want = j_ivf_refresh_host(ivf.theta_np, ix.gp, ivf.gmask, ix.gids_host,
                              **kw)
    for name, a, b in zip(("q", "s", "n2", "mu", "sd", "fn", "cent", "cn2",
                           "bq", "pack", "binv"), got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)
    # and the port's build lands every row where the oracle does
    np.testing.assert_array_equal(ix.binv.numpy(), got[-1])


def test_refresh_ivf_function_equals_index_image(ivf):
    ix = ivf.index
    out = index_refresh_ivf(ivf.theta, _t(ix.gp), _t(ivf.gmask),
                            _t(ix.gids_host), nlist=16, bcap=32, iters=4,
                            train_cap=ix.ivf_train_cap, balance=0.1)
    for name, a in zip(("gq", "gscale", "gn2", "bn_mu", "bn_sd", "gf",
                        "cent", "cn2", "bq", "pack", "binv"), out):
        b = getattr(ix, name)
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float32
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.float32 else b), name


def test_ivf_all_invalid_client():
    """A client with no valid row builds an all-empty image and answers -1,
    like the exact path; the other client's rows all land."""
    rng = np.random.default_rng(3)
    p0, _ = _clustered(rng, 64)
    protos = [p0, np.zeros((0, CFG.proto_dim), np.float32)]
    ids = [np.arange(64, dtype=np.int32), np.zeros((0,), np.int32)]
    index = GalleryIndex(protos, ids, nlist=8, bcap=16, ivf_iters=2,
                         device="cpu")
    theta_np = _jax_heads(2, seed=3)
    theta = theta_from_jax(theta_np, "cpu")
    eng8 = RetrievalEngine(index, theta, k=5, mode="int8")
    engv = RetrievalEngine(index, theta, k=5, mode="ivf", nprobe=2,
                           refresh=False)
    binv = index.binv.numpy()
    assert np.all(binv[1] == -1)
    assert sorted(binv[0][binv[0] >= 0]) == list(range(64))
    jindex = JIndex(protos, ids, nlist=8, bcap=16, ivf_iters=2,
                    backend="ref")
    JEngine(jindex, theta_np, k=5, mode="ivf", nprobe=2, backend="ref")
    np.testing.assert_array_equal(binv, np.asarray(jindex.binv))
    qp = rng.standard_normal((2, 3, CFG.proto_dim)).astype(np.float32)
    qm = np.ones((2, 3), np.float32)
    assert np.all(eng8.query_batch(qp, qm)[0][1] == -1)
    assert np.all(engv.query_batch(qp, qm)[0][1] == -1)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def _jax_image(ivf, backend):
    jindex = JIndex(ivf.protos, ivf.ids, backend=backend, **IVF)
    jeng = JEngine(jindex, ivf.theta_np, k=10, mode="ivf", nprobe=4,
                   backend=backend)
    return jindex, jeng


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_ivf_matches_jax(ivf, backend):
    """The port's ``query_ivf`` over the JAX package's image against
    ``query_ivf_program`` (ids equal, distances 1e-5), the JAX numpy oracle
    and the port's copy of it; and the two engines end to end."""
    jindex, jeng = _jax_image(ivf, backend)
    qp, qm = _queries(ivf.rng, ivf.centers, 6)
    qm[0, 4:] = 0.0                              # padded slots come back -1
    img = [np.asarray(a) for a in (jindex.bn_mu, jindex.bn_sd, jindex.cent,
                                   jindex.cn2, jindex.bq, jindex.pack)]
    mu, sd, cent, cn2, bq, pack = img
    ids_t, d_t = query_ivf(ivf.theta, _t(mu), _t(sd), _t(qp), _t(qm),
                           _t(cent), _t(cn2), _t(bq), _t(pack), k=10,
                           nprobe=4)
    ids_j, d_j = query_ivf_program(ivf.theta_np, mu, sd, qp, qm, cent, cn2,
                                   bq, pack, k=10, nprobe=4, backend=backend)
    valid = qm > 0
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(d_t.numpy()[valid], np.asarray(d_j)[valid],
                               atol=1e-5)
    assert np.all(ids_t.numpy()[~valid] == -1)
    ids_h, d_h = query_ivf_host(ivf.theta, mu, sd, qp, qm, cent, cn2, bq,
                                pack, k=10, nprobe=4)
    ids_jh, d_jh = j_query_ivf_host(ivf.theta_np, mu, sd, qp, qm, cent, cn2,
                                    bq, pack, k=10, nprobe=4)
    np.testing.assert_array_equal(ids_h, ids_jh)
    np.testing.assert_array_equal(d_h, d_jh)
    np.testing.assert_array_equal(ids_t.numpy(), ids_h)
    np.testing.assert_allclose(d_t.numpy()[valid], d_h[valid], atol=1e-5)
    # end to end: each package's own refresh, then its engine
    got = ivf.engv.query_batch(qp, qm)
    want = jeng.query_batch(qp, qm)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1][valid], want[1][valid], atol=1e-5)


def test_query_ivf_matches_its_host_oracle(ivf):
    ix = ivf.index
    qp, qm = _queries(ivf.rng, ivf.centers, 9)
    ids_d, d_d = ivf.engv.query_batch(qp, qm)
    ids_h, d_h = query_ivf_host(ivf.engv.theta, ix.bn_mu, ix.bn_sd, qp, qm,
                                ix.cent, ix.cn2, ix.bq, ix.pack, k=10,
                                nprobe=ivf.engv.nprobe)
    np.testing.assert_array_equal(ids_d, ids_h)
    np.testing.assert_allclose(d_d, d_h, atol=1e-5)


def test_full_probe_equals_exact_int8(ivf):
    """nprobe == nlist scores every bucket, so the shortlist is the whole
    gallery: the exact int8 path's ids, its distances."""
    engall = RetrievalEngine(ivf.index, ivf.theta, k=10, mode="ivf",
                             nprobe=ivf.index.nlist, refresh=False)
    qp, qm = _queries(ivf.rng, ivf.centers, 8)
    qm[0, 6:] = 0.0
    i8, d8 = ivf.eng8.query_batch(qp, qm)
    iv, dv = engall.query_batch(qp, qm)
    np.testing.assert_array_equal(iv, i8)
    np.testing.assert_allclose(dv[qm > 0], d8[qm > 0], atol=1e-5)
    assert np.all(iv[0, 6:] == -1)


def test_ivf_recall_clustered(ivf):
    """nprobe = nlist / 4 on clustered data keeps nearly every true
    neighbour (the reference's bar at this fixture)."""
    qp, qm = _queries(ivf.rng, ivf.centers, 32)
    i8, _ = ivf.eng8.query_batch(qp, qm)
    iv, _ = ivf.engv.query_batch(qp, qm)
    assert recall_at_k(iv, i8, qm) >= 0.9


def test_update_bit_identical_to_fresh_engine(ivf):
    """update(theta2) rebuilds the whole IVF image bit for bit as a fresh
    engine under theta2 does."""
    def fresh(theta):
        protos, ids, _, _ = _fixture_data()
        return RetrievalEngine(GalleryIndex(protos, ids, device="cpu", **IVF),
                               theta, k=5, mode="ivf", nprobe=4)

    eng = fresh(ivf.theta)
    old = eng.index.binv.clone()
    theta2 = theta_from_jax(_jax_heads(3, seed=7), "cpu")
    eng.update(theta2)
    ref_eng = fresh(theta2)
    assert not torch.equal(old, eng.index.binv)
    for name in ("cent", "cn2", "bq", "pack", "binv"):
        a, b = getattr(eng.index, name), getattr(ref_eng.index, name)
        assert torch.equal(a.view(torch.uint8) if a.is_floating_point() else a,
                           b.view(torch.uint8) if b.is_floating_point() else b
                           ), name
    qp = np.random.default_rng(8).standard_normal(
        (3, 3, CFG.proto_dim)).astype(np.float32)
    qm = np.ones((3, 3), np.float32)
    np.testing.assert_array_equal(eng.query_batch(qp, qm)[0],
                                  ref_eng.query_batch(qp, qm)[0])


def test_ivf_batch_composition_invariance(ivf):
    engv = ivf.engv
    rng = np.random.default_rng(9)
    probe = rng.standard_normal(CFG.proto_dim).astype(np.float32)
    qp1 = np.zeros((3, 1, CFG.proto_dim), np.float32)
    qp1[1, 0] = probe
    m1 = np.zeros((3, 1), np.float32)
    m1[1, 0] = 1.0
    ids1, d1 = engv.query_batch(qp1, m1)
    qp8 = rng.standard_normal((3, 8, CFG.proto_dim)).astype(np.float32)
    qp8[1, 3] = probe
    ids8, d8 = engv.query_batch(qp8, np.ones((3, 8), np.float32))
    np.testing.assert_array_equal(ids1[1, 0], ids8[1, 3])
    np.testing.assert_allclose(d1[1, 0], d8[1, 3], atol=1e-5)


def test_ivf_metrics_match_jax(ivf):
    ix = ivf.index
    qp, qm = _queries(ivf.rng, ivf.centers, 7)
    qm[2, 5:] = 0.0
    top, _, mets = query_ivf(ivf.engv.theta, ix.bn_mu, ix.bn_sd, _t(qp),
                             _t(qm), ix.cent, ix.cn2, ix.bq, ix.pack, k=10,
                             nprobe=4, with_metrics=True)
    # the same launch's tensors through the JAX function
    f = featurize(ivf.engv.theta, ix.bn_mu, ix.bn_sd, _t(qp))
    probe = ops.batched_cluster_assign(f, ix.cent, ix.cn2, nprobe=4)
    d, ids = ops.batched_ivf_shortlist(f, probe, ix.bq, ix.pack)
    _, _, idx = rank_shortlist(d, ids, f, _t(qm), 10)
    want = j_ivf_metrics(ids.numpy(), qm, idx.numpy(), ix.bcap, 4)
    mine = ivf_metrics(ids, _t(qm), idx, ix.bcap, 4)
    for key in ("rows_scored", "probe_hits"):
        np.testing.assert_array_equal(mets[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(mine[key].numpy(), np.asarray(want[key]))
    assert mets["rows_scored"].tolist()[2] < mets["rows_scored"].tolist()[0]
    assert float(mets["probe_hits"].sum()) == 10 * qm.sum()


@pytest.mark.parametrize("policy", ["fifo", "drr"])
def test_batcher_drives_an_ivf_engine(ivf, policy):
    """The engine-agnostic batcher answers ivf tickets exactly as a direct
    query_batch does, under both admission policies."""
    b = ContinuousBatcher(ivf.engv, batch=4, policy=policy,
                          step_budget=6 if policy == "drr" else None)
    rng = np.random.default_rng(10)
    protos = rng.standard_normal((10, CFG.proto_dim)).astype(np.float32)
    tickets = [b.submit(i % 3, protos[i], qid=i) for i in range(10)]
    b.drain()
    assert b.pending == 0
    for t, p in zip(tickets, protos):
        qp = np.zeros((3, 1, CFG.proto_dim), np.float32)
        qp[t.client, 0] = p
        m = np.zeros((3, 1), np.float32)
        m[t.client, 0] = 1.0
        np.testing.assert_array_equal(t.ids, ivf.engv.query_batch(qp, m)[0][
            t.client, 0])


def test_ivf_index_shapes_match_jax(ivf):
    """nlist="auto", the default bcap and train cap, the resident bytes and
    the shape checks are the reference's."""
    G = 131072
    protos = [np.zeros((1, CFG.proto_dim), np.float32)]
    ids = [np.zeros(1, np.int32)]
    ours = GalleryIndex(protos, ids, capacity=G, nlist="auto", device="cpu")
    theirs = JIndex(protos, ids, capacity=G, nlist="auto")
    assert (ours.nlist, ours.bcap, ours.ivf_train_cap) == (512, 384, 16384)
    assert (ours.nlist, ours.bcap, ours.ivf_train_cap) == (
        theirs.nlist, theirs.bcap, theirs.ivf_train_cap)
    for mode in ("int8", "fp32", "ivf"):
        assert ours.resident_bytes(mode) == theirs.resident_bytes(mode)
    assert not ours.has_ivf and ivf.index.has_ivf
    with pytest.raises(ValueError, match="every row needs a slot"):
        GalleryIndex(protos, ids, capacity=64, nlist=4, bcap=8, device="cpu")
    with pytest.raises(ValueError, match="int32 sort key"):
        GalleryIndex(protos, ids, capacity=1 << 20, nlist=4096, device="cpu")
    with pytest.raises(ValueError, match="nlist > 0"):
        RetrievalEngine(GalleryIndex(ivf.protos, ivf.ids, device="cpu"),
                        ivf.theta, mode="ivf")
    eng = RetrievalEngine(ivf.index, ivf.theta, mode="ivf", nprobe=99,
                          refresh=False)
    assert eng.nprobe == ivf.index.nlist


def test_serve_launcher_ivf_on_cpu(capsys):
    out = serve_cli.main(["--device", "cpu", "--clients", "2", "--gallery",
                          "512", "--queries", "16", "--batch", "4", "--mode",
                          "ivf", "--nprobe", "4"])
    assert out["pre"]["n"] == 8 and out["post"]["n"] == 8
    assert all(t.ids.shape == (10,) and (t.ids >= 0).all()
               for t in out["post"]["tickets"])
    text = capsys.readouterr().out
    assert "mode=ivf" in text and "post-update: 8 queries" in text
