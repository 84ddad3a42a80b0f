"""The port's plain kernel versions (repro_torch.kernels.ref, reached through
the device dispatch in repro_torch.kernels.ops) against the JAX package's
kernels on the same numpy inputs — its jnp ``ref`` path and its Pallas
kernel in interpret mode.

Tolerances: quantization is bit-exact (IEEE division, round half to even);
distances agree to atol = rtol = 1e-5 (fp32 sums over F in another order);
the 2-D distances likewise; dequantization bit-exact (one IEEE product);
the adaptive combine bit-exact against the reference's expression run
eagerly (a product and a sum, each rounded; gradients equal to autograd's
of ``B*alpha + A`` bit for bit) and, against its jitted ``ref`` and
``interpret`` paths, which XLA contracts into one fused multiply-add on
the CPU (ROADMAP Queue 3), within the product's rounding: half an ulp of
B*alpha plus an ulp of the result; the plain
relevance aggregate to atol 1e-6 (fp32 products over C <= 7 terms);
KL similarities to atol 4e-6 against the JAX package (its fp32 h and
cross term are each about -log D ~ -5, and it lies up to ~2e-6 from a
float64 evaluation of S) and to atol 5e-7 against float64 (the port shifts
both terms by log D, see ``ref.kl_similarity_ref``); the
normalized relevance Wn to atol 1e-6 and the aggregate B to 1e-5.
The CUDA kernels themselves run only on the card: chip_smoke.py holds each
against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.kernels import ops, ref
from repro_torch.kernels.adaptive_combine import adaptive_combine
from repro_torch.kernels.int8_dist import batched_int8_pairwise_dist
from repro_torch.kernels.ivf import (batched_cluster_dist,
                                     batched_ivf_shortlist_scores)
from repro_torch.kernels.kl_similarity import SPLIT_MIN_TILES
from repro_torch.kernels.kl_similarity import Plan as KLPlan
from repro_torch.kernels.kl_similarity import _plan as kl_plan
from repro_torch.kernels.kl_similarity import kl_similarity
from repro_torch.kernels.pairwise_dist import Plan as DPlan
from repro_torch.kernels.pairwise_dist import _plan as dist_plan
from repro_torch.kernels.pairwise_dist import (batched_pairwise_dist,
                                               pairwise_dist)
from repro_torch.kernels.quantize import Plan as QPlan
from repro_torch.kernels.quantize import _plan as quantize_plan
from repro_torch.kernels.quantize import batched_dequantize, batched_quantize
from repro_torch.kernels.relevance_aggregate import (
    SKINNY_MAX_C, Plan, _plan, fused_relevance_aggregate,
    relevance_aggregate)

SHAPES = [(3, 4, 40, 64), (2, 16, 300, 64), (1, 1, 7, 32)]
BACKENDS = ["ref", "interpret"]


def _int8_gallery(g):
    C, G, F = g.shape
    q8, s = ref.batched_quantize_ref(torch.from_numpy(g.reshape(C, G * F)),
                                     chunk=F)
    gq = q8.reshape(C, G, F)
    gn2 = torch.sum(torch.square(gq.float()), -1) * torch.square(s)
    return gq.numpy(), s.numpy(), gn2.numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("C,B,G,F", SHAPES)
def test_quantize_bit_exact(C, B, G, F, backend):
    rng = np.random.default_rng(G)
    x = rng.standard_normal((C, G * F)).astype(np.float32)
    qt, st = ops.batched_quantize(torch.from_numpy(x), chunk=F)
    qj, sj = JOPS.batched_quantize(x, chunk=F, backend=backend)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))


@pytest.mark.parametrize("P,chunk", [(1000, 64), (999, 256), (37, 64)])
def test_quantize_tail_chunk(P, chunk):
    """P not a multiple of chunk: the short tail chunk has its own scale."""
    rng = np.random.default_rng(P)
    x = rng.standard_normal((2, P)).astype(np.float32) * 3.0
    qt, st = ops.batched_quantize(torch.from_numpy(x), chunk=chunk)
    assert qt.shape == (2, P) and st.shape == (2, -(-P // chunk))
    for backend in BACKENDS:
        qj, sj = JOPS.batched_quantize(x, chunk=chunk, backend=backend)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_zero_chunk_scale_one():
    x = np.zeros((2, 128), np.float32)
    x[1, 64:] = np.linspace(-1, 1, 64)
    q, s = ops.batched_quantize(torch.from_numpy(x), chunk=64)
    assert s[0, 0] == 1.0 and s[0, 1] == 1.0 and s[1, 0] == 1.0
    assert s[1, 1] == np.float32(1.0) / np.float32(127.0)
    assert not q[0].any() and not q[1, :64].any()


def test_quantize_rounds_half_to_even():
    """With absmax 127 the scale is exactly 1.0, so x / scale lands exactly
    on the half-way points: they round to the even code, as jnp.round."""
    vals = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                    np.float32)
    x = vals[None, :]
    q, s = ops.batched_quantize(torch.from_numpy(x), chunk=8)
    assert s.item() == 1.0
    np.testing.assert_array_equal(q.numpy()[0],
                                  [127, 0, 2, 2, 0, -2, -2, 126])
    qj, _ = JOPS.batched_quantize(x, chunk=8, backend="ref")
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("C,B,G,F", SHAPES)
def test_int8_pairwise_dist_matches_jax(C, B, G, F, backend):
    rng = np.random.default_rng(B * G)
    q = rng.standard_normal((C, B, F)).astype(np.float32)
    gq, gs, gn2 = _int8_gallery(rng.standard_normal((C, G, F))
                                .astype(np.float32))
    dt = ops.batched_int8_pairwise_dist(*map(torch.from_numpy,
                                             (q, gq, gs, gn2)))
    dj = JOPS.batched_int8_pairwise_dist(q, gq, gs, gn2, backend=backend)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("C,B,G,F", SHAPES)
def test_pairwise_dist_matches_jax(C, B, G, F, backend):
    rng = np.random.default_rng(C * G)
    q = rng.standard_normal((C, B, F)).astype(np.float32)
    g = rng.standard_normal((C, G, F)).astype(np.float32)
    dt = ops.batched_pairwise_dist(torch.from_numpy(q), torch.from_numpy(g))
    dj = JOPS.batched_pairwise_dist(q, g, backend=backend)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P,chunk", [(999, 256), (14136, 256), (37, 64),
                                     (4096, 256)])
def test_dequantize_bit_exact(P, chunk, backend):
    """Codes from the quantizer, a ragged P (the codec's K = 14136 has a
    tail chunk of 56), an all-zero chunk (scale 1.0) and the code extremes:
    one IEEE product each, bit for bit the JAX package's."""
    rng = np.random.default_rng(P + chunk)
    x = (rng.standard_normal((3, P)) * 2.0).astype(np.float32)
    x[1, :chunk] = 0.0
    q, s = ref.batched_quantize_ref(torch.from_numpy(x), chunk=chunk)
    q[2, :3] = torch.tensor([127, -127, 0], dtype=torch.int8)
    out = ops.batched_dequantize(q, s, chunk=chunk)
    jout = JOPS.batched_dequantize(q.numpy(), s.numpy(), chunk=chunk,
                                   backend=backend)
    assert out.shape == (3, P) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  np.asarray(jout).view(np.int32))
    assert not out[1, :chunk].any()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("R,C,P", [(5, 5, 1000), (2, 5, 3001), (1, 7, 129),
                                   (70, 70, 333), (129, 129, 333),
                                   (5, 33, 1000)])
def test_relevance_aggregate_matches_jax(R, C, P, backend):
    """(R, C) normalized rows x (C, P): R < C (the host server skips rows
    without relevant neighbours) and R = C, ragged P; R = 129 one past the
    kernel's 128-row tile, C = 33 one past the skinny variant's largest."""
    rng = np.random.default_rng(R * C + P)
    w = rng.random((R, C)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    th = rng.standard_normal((C, P)).astype(np.float32)
    bt = ops.relevance_aggregate(torch.from_numpy(w), torch.from_numpy(th))
    bj = JOPS.relevance_aggregate(w, th, backend=backend)
    assert bt.shape == (R, P)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", [(3, 128, 200), (64,), (5, 7), (1,)])
def test_adaptive_combine_bit_exact_with_autograd_gradients(shape, backend):
    """theta = B * alpha + A on leaves of several shapes: bit for bit the
    reference's ``adaptive_combine_ref`` run eagerly (two roundings, as the
    CUDA kernel's __fadd_rn(__fmul_rn(b, al), a)); the jitted ``ref`` and
    ``interpret`` paths round once (XLA fuses the two into an FMA on the
    CPU: equal to the float64-evaluated FMA here) and differ by the
    product's rounding at most (half an ulp of B*alpha, plus an ulp of the
    result).
    The autograd.Function's gradients are bit for bit autograd's of the
    plain expression, with and without B needing one."""
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    b, al, a = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(3))
    out = ops.adaptive_combine(*map(torch.from_numpy, (b, al, a)))
    eager = JREF.adaptive_combine_ref(*map(jnp.asarray, (b, al, a)))
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  np.asarray(eager).view(np.int32))
    jout = np.asarray(JOPS.adaptive_combine(b, al, a, backend=backend))
    fma = (b.astype(np.float64) * al + a).astype(np.float32)
    np.testing.assert_array_equal(jout, fma)
    prod = b * al
    bound = 0.5 * np.spacing(np.abs(prod)) + np.spacing(np.abs(jout))
    assert (np.abs(out.numpy() - jout) <= bound).all()
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    for b_grad in (True, False):
        fn_in = [torch.from_numpy(v).requires_grad_(rg)
                 for v, rg in ((b, b_grad), (al, True), (a, True))]
        plain_in = [t.detach().clone().requires_grad_(t.requires_grad)
                    for t in fn_in]
        ops.adaptive_combine(*fn_in).backward(g)
        (plain_in[0] * plain_in[1] + plain_in[2]).backward(g)
        for t, u in zip(fn_in, plain_in):
            assert (t.grad is None) == (u.grad is None)
            if t.grad is not None:
                assert torch.equal(t.grad, u.grad)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("Q,G,D", [(4, 40, 64), (16, 300, 64), (1, 7, 32)])
def test_pairwise_dist_2d_matches_jax(Q, G, D, backend):
    rng = np.random.default_rng(Q * G)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    g = rng.standard_normal((G, D)).astype(np.float32)
    dt = ops.pairwise_dist(torch.from_numpy(q), torch.from_numpy(g))
    dj = JOPS.pairwise_dist(q, g, backend=backend)
    assert dt.shape == (Q, G)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                               atol=1e-5, rtol=1e-5)


KERNEL_CALLS = [
    (batched_quantize, lambda: (torch.zeros(2, 64),)),
    (batched_int8_pairwise_dist,
     lambda: (torch.zeros(1, 2, 8), torch.zeros(1, 3, 8, dtype=torch.int8),
              torch.ones(1, 3), torch.zeros(1, 3))),
    (batched_pairwise_dist, lambda: (torch.zeros(1, 2, 8),
                                     torch.zeros(1, 3, 8))),
    (kl_similarity, lambda: (torch.zeros(2, 8), torch.zeros(3, 8))),
    (fused_relevance_aggregate, lambda: (torch.zeros(2, 2),
                                         torch.zeros(2, 5))),
    (batched_cluster_dist, lambda: (torch.zeros(1, 2, 8), torch.zeros(1, 3, 8),
                                    torch.zeros(1, 3))),
    (batched_ivf_shortlist_scores,
     lambda: (torch.zeros(1, 2, 8), torch.zeros(1, 2, 2, dtype=torch.int32),
              torch.zeros(1, 3, 4, 8, dtype=torch.int8),
              torch.zeros(1, 3, 3, 4))),
    (batched_dequantize, lambda: (torch.zeros(2, 64, dtype=torch.int8),
                                  torch.ones(2, 1))),
    (relevance_aggregate, lambda: (torch.zeros(1, 2), torch.zeros(2, 5))),
    (adaptive_combine, lambda: (torch.zeros(3, 4),) * 3),
    (pairwise_dist, lambda: (torch.zeros(2, 8), torch.zeros(3, 8))),
]


@pytest.mark.parametrize("wrapper,args", KERNEL_CALLS,
                         ids=[w.__name__ for w, _ in KERNEL_CALLS])
def test_kernel_wrapper_refuses_cpu_tensors(wrapper, args):
    """The CUDA wrappers take CUDA tensors only; CPU tensors reach the
    plain versions through ops, and the launch count does not move."""
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wrapper(*args())
    assert wrapper.launches == before


def test_ops_dispatch_cpu_to_plain_and_rejects_mixed_devices():
    x = torch.randn(2, 64)
    counts = (batched_quantize.launches, batched_pairwise_dist.launches)
    q, s = ops.batched_quantize(x, chunk=64)
    qr, sr = ref.batched_quantize_ref(x, chunk=64)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    ops.batched_pairwise_dist(torch.randn(1, 2, 8), torch.randn(1, 3, 8))
    assert (batched_quantize.launches, batched_pairwise_dist.launches) == counts
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        ops.batched_pairwise_dist(torch.randn(1, 2, 8),
                                  torch.randn(1, 3, 8, device="meta"))


KL_SHAPES = [(5, 30, 128), (7, 41, 128), (3, 5, 37), (130, 200, 64)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("N,M,D", KL_SHAPES)
def test_kl_similarity_matches_jax(N, M, D, backend):
    """Ragged N and M (not multiples of any tile), task-feature-like and
    standard-normal rows."""
    rng = np.random.default_rng(N * M)
    for a, b in ((np.tanh(rng.standard_normal((N, D))),
                  np.tanh(rng.standard_normal((M, D)))),
                 (rng.standard_normal((N, D)),
                  rng.standard_normal((M, D)))):
        a, b = a.astype(np.float32), b.astype(np.float32)
        st = ops.kl_similarity(torch.from_numpy(a), torch.from_numpy(b))
        sj = JOPS.kl_similarity(a, b, backend=backend)
        assert st.shape == (N, M) and bool(torch.isfinite(st).all())
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=4e-6)
        assert float(st.max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("kind", ["tanh", "normal"])
def test_kl_similarity_close_to_float64(kind):
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal((64, 128)), rng.standard_normal((384, 128))
    if kind == "tanh":                         # task-feature-like rows
        a, b = np.tanh(a), np.tanh(b)
    a, b = a.astype(np.float32), b.astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    la = a64 - a64.max(1, keepdims=True)
    la -= np.log(np.exp(la).sum(1, keepdims=True))
    lb = b64 - b64.max(1, keepdims=True)
    lb -= np.log(np.exp(lb).sum(1, keepdims=True))
    pa = np.exp(la)
    exact = np.exp(pa @ lb.T - (pa * la).sum(1)[:, None])
    st = ops.kl_similarity(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(st.numpy(), exact, atol=5e-7)


def _relevance(rng, C, diag):
    w = rng.random((C, C)).astype(np.float32)
    np.fill_diagonal(w, diag)
    return w


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("C,P", [(5, 1000), (7, 1001), (70, 333), (3, 1),
                                 (33, 1000), (129, 333)])
def test_fused_relevance_aggregate_matches_jax(C, P, backend):
    """Ragged P, finite junk on the diagonal, a zero row, a row whose only
    mass is on the diagonal (zero once masked); C = 33 one past the skinny
    variant's largest, 129 one past the tile's 128 rows."""
    rng = np.random.default_rng(C * P)
    w = _relevance(rng, C, 123.0)
    w[1] = 0.0
    w[C - 1] = 0.0
    w[C - 1, C - 1] = 5.0
    th = rng.standard_normal((C, P)).astype(np.float32)
    bt, wnt = ops.fused_relevance_aggregate(torch.from_numpy(w),
                                            torch.from_numpy(th))
    bj, wnj = JOPS.fused_relevance_aggregate(w, th, backend=backend)
    np.testing.assert_allclose(wnt.numpy(), np.asarray(wnj), atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-5)
    assert not wnt[1].any() and not wnt[C - 1].any()
    assert not bt[1].any() and not bt[C - 1].any()
    assert not wnt.diagonal().any()
    np.testing.assert_allclose(wnt.sum(1)[2:C - 1].numpy(), 1.0, atol=1e-6)


def test_fused_relevance_aggregate_all_zero_and_nan_diagonal():
    """An all-zero W gives zero bases and a zero Wn; NaN on the diagonal
    never leaks (the kernel's ``where``). The JAX ``ref`` multiplies by
    (1 - I) instead: NaN * 0 is NaN, its row sums are NaN and it zeroes
    those rows, so there the interpret kernel is the oracle."""
    rng = np.random.default_rng(9)
    th = rng.standard_normal((4, 50)).astype(np.float32)
    b, wn = ops.fused_relevance_aggregate(torch.zeros(4, 4),
                                          torch.from_numpy(th))
    assert not b.any() and not wn.any()
    w = _relevance(rng, 4, np.nan)
    bt, wnt = ops.fused_relevance_aggregate(torch.from_numpy(w),
                                            torch.from_numpy(th))
    assert bool(torch.isfinite(bt).all()) and bool(torch.isfinite(wnt).all())
    bj, wnj = JOPS.fused_relevance_aggregate(w, th, backend="interpret")
    np.testing.assert_allclose(wnt.numpy(), np.asarray(wnj), atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-5)
    assert not np.asarray(JOPS.fused_relevance_aggregate(
        w, th, backend="ref")[1]).any()
    assert bool((wnt.sum(1) > 0.99).all())


# (R, C, P, aligned) -> the plan: the round's shapes (fused C = 5 at the
# round's and the edge model's P; the host rows R <= 5 of C = 5), the
# fleet's C = 100 and 1000, R of 1, 127, 129 and 1001 around the 128-row
# tile (scratch rows rounded up to 4 for TMA's 16-byte strides), the
# skinny variant's edge, ragged P and misaligned bases (ragged), P = 0
PLANS = [
    ((5, 5, 37696, True), Plan("skinny", 74, None)),
    ((5, 5, 57664, True), Plan("skinny", 113, None)),
    ((3, 5, 37696, True), Plan("skinny", 74, None)),
    ((32, 32, 1000, True), Plan("skinny", 8, None)),
    ((9, 9, 1000, True), Plan("skinny", 4, None)),
    ((33, 33, 1000, True), Plan("tiled", 8, (33, 36))),
    ((100, 100, 57664, True), Plan("tiled", 451, (100, 100))),
    ((1000, 1000, 57664, True), Plan("tiled", 3608, (1000, 1000))),
    ((1, 100, 57664, True), Plan("tiled", 451, (100, 4))),
    ((127, 200, 1000, True), Plan("tiled", 8, (200, 128))),
    ((129, 129, 37696, True), Plan("tiled", 590, (129, 132))),
    ((1001, 1001, 1000, True), Plan("tiled", 64, (1001, 1004))),
    ((5, 5, 37696, False), Plan("ragged", 295, (5, 8))),
    ((7, 7, 1001, True), Plan("ragged", 8, (7, 8))),
    ((1001, 1001, 333, True), Plan("ragged", 24, (1001, 1004))),
    ((5, 5, 0, True), Plan("skinny", 1, None)),
]


@pytest.mark.parametrize("args,plan", PLANS, ids=[
    "-".join(map(str, a)) for a, _ in PLANS])
def test_aggregate_plan(args, plan):
    """The variant, product grid and scratch shape the aggregate wrappers
    hand the CUDA entry points: tiles of 128 x 128 outputs, the row tiles
    of one column slab neighbours (grid = row tiles x column tiles), the
    skinny variant's blocks of 128 float4 columns x 8 rows, a scratch (C,
    ld) with ld = R rounded up to 4."""
    got = _plan(*args)
    assert got == plan
    R, C, P, aligned = args
    if got.scratch is not None:
        assert got.scratch[0] == C and got.scratch[1] % 4 == 0
        assert R <= got.scratch[1] < R + 4
    assert (got.variant == "skinny") == (aligned and P % 4 == 0
                                         and max(R, C) <= SKINNY_MAX_C)


# (Cp, lo, hi, P, aligned) of the fused entry's column-block form -> its
# plan, _plan(Cp, hi - lo, P): the sharded round's C = 5 on worlds of 1, 2
# and 4 (Cp 5, 6, 8), the skinny variant's edge, a fleet's rank blocks,
# ragged P and a misaligned base
BLOCK_PLANS = [
    ((5, 0, 5, 37696, True), Plan("skinny", 74, None)),
    ((6, 3, 6, 37696, True), Plan("skinny", 74, None)),
    ((8, 6, 8, 18848, True), Plan("skinny", 37, None)),
    ((32, 0, 8, 1000, True), Plan("skinny", 8, None)),
    ((33, 22, 33, 1000, True), Plan("tiled", 8, (11, 36))),
    ((100, 25, 50, 57664, True), Plan("tiled", 451, (25, 100))),
    ((1000, 750, 1000, 14416, True), Plan("tiled", 904, (250, 1000))),
    ((40, 39, 40, 1000, True), Plan("tiled", 8, (1, 40))),
    ((6, 0, 3, 1001, True), Plan("ragged", 8, (3, 8))),
    ((6, 0, 3, 1000, False), Plan("ragged", 8, (3, 8))),
]


@pytest.mark.parametrize("args,plan", BLOCK_PLANS, ids=[
    "-".join(map(str, a)) for a, _ in BLOCK_PLANS])
def test_block_aggregate_plan(args, plan):
    """The column-block form plans its product as (Cp, hi - lo) x (hi - lo,
    P): skinny (one launch, every block normalizing W) at Cp <= 32 with an
    aligned Theta, tiled or ragged above, the scratch holding Wn's columns
    lo..hi k-major (hi - lo rows of Cp rounded up to 4)."""
    Cp, lo, hi, P, aligned = args
    got = _plan(Cp, hi - lo, P, aligned)
    assert got == plan
    assert (got.variant == "skinny") == (aligned and P % 4 == 0
                                         and Cp <= SKINNY_MAX_C)
    if got.scratch is not None:
        assert got.scratch == (hi - lo, -(-Cp // 4) * 4)


@pytest.mark.parametrize("lo,hi", [(-1, 2), (3, 2), (2, 2), (0, 5), (5, 6)])
def test_block_wrapper_refuses_blocks_outside_w(lo, hi):
    """The fused wrapper checks its column block against W's columns before
    anything else (an empty block is refused too), takes CUDA tensors only
    on a block inside W, and its launch count does not move."""
    before = fused_relevance_aggregate.launches
    with pytest.raises(ValueError, match="empty or outside W's 4 columns"):
        fused_relevance_aggregate(torch.zeros(4, 4),
                                  torch.zeros(max(hi - lo, 0), 8), lo, hi)
    with pytest.raises(ValueError, match=r"expected w \(C, C\)"):
        fused_relevance_aggregate(torch.zeros(4), torch.zeros(1, 8), 0, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fused_relevance_aggregate(torch.zeros(4, 4), torch.zeros(2, 8), 1, 3)
    assert fused_relevance_aggregate.launches == before


@pytest.mark.parametrize("C", (1, 5, 33, 300))
def test_block_plain_version_on_the_whole_block_is_the_fused_one(C):
    """``ops.fused_relevance_aggregate(w, thetas, 0, C)`` on the CPU
    is the fused plain version bit for bit (B and Wn), with finite junk on
    the diagonal, an all-zero row and a NaN off the diagonal; a block's B
    is that of its slice of Wn, bit for bit, and the column blocks' B sum
    to the whole B."""
    rng = np.random.default_rng(C + 32)
    w = _relevance(rng, C, 7.5)
    w[0] = 0.0
    if C > 2:
        w[2, 0] = np.nan
    wt = torch.from_numpy(w)
    th = torch.from_numpy(rng.standard_normal((C, 37)).astype(np.float32))
    b, wn = ops.fused_relevance_aggregate(wt, th)
    bc, wnc = ops.fused_relevance_aggregate(wt, th, 0, C)
    assert torch.equal(bc, b) and torch.equal(wnc, wn)
    assert not torch.isnan(wn).any() and not wn[0].any()
    total = torch.zeros_like(b)
    for lo, hi in _blocks(C, 4):
        bb, wnb = ops.fused_relevance_aggregate(wt, th[lo:hi], lo, hi)
        assert torch.equal(wnb, wn)
        assert torch.equal(bb, ref.relevance_aggregate_ref(
            wn[:, lo:hi].contiguous(), th[lo:hi]))
        total += bb
    np.testing.assert_allclose(total.numpy(), b.numpy(), atol=1e-5)


def _blocks(C, d):
    """[lo, hi) of C columns dealt into at most d contiguous blocks."""
    edges = np.linspace(0, C, min(C, d) + 1).round().astype(int)
    return list(zip(edges[:-1].tolist(), edges[1:].tolist()))


AGG_TOL = 2e-5   # chip_smoke.py's bar for the kernels against torch.mm


def test_tile_summation_order_has_margin_at_the_fleet_shape():
    """The kernels sum each output by fp32 FMAs in ascending k from 0. That
    chain, emulated at C = 1000 (normalized relevance rows x 64
    standard-normal columns; each step's product and sum taken in float64,
    the float64 product of two fp32 values exact, then rounded to fp32),
    and the plain version's torch.mm on the CPU each lie within 1e-6 of
    float64, so the two together stay at a fiftieth of AGG_TOL or less
    (1.7e-7 apart): the bar has margin at the fleet's shape."""
    rng = np.random.default_rng(19)
    C, P = 1000, 64
    w = rng.random((C, C)).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    wn = ref.normalize_relevance_ref(torch.from_numpy(w)).numpy()
    th = rng.standard_normal((C, P)).astype(np.float32)
    acc = np.zeros((C, P), np.float32)
    for k in range(C):
        acc = (np.outer(wn[:, k].astype(np.float64), th[k].astype(np.float64))
               + acc.astype(np.float64)).astype(np.float32)
    exact = wn.astype(np.float64) @ th.astype(np.float64)
    plain = ref.relevance_aggregate_ref(torch.from_numpy(wn),
                                        torch.from_numpy(th)).numpy()
    e_chain = np.abs(acc - exact).max()
    e_plain = np.abs(plain - exact).max()
    assert e_chain <= 1e-6 and e_plain <= 1e-6
    assert np.abs(acc - plain).max() <= e_chain + e_plain <= AGG_TOL / 50


# (C, P, chunk, aligned) -> the quantizer's plan: the refresh's shape (one
# scale a 64-wide row), the codec's keyframe and residuals at the round's
# and the fleet's C (K = 14136 and 21624 are 8 mod 16: 8-byte code
# stores), 4 mod 16 (4-byte stores), a chunk of 16 and one that loops
# (1024), and the scalar cases: a chunk that is no power of two (40, 48),
# P % 4 != 0, a misaligned base, more rows than the grid's y
QUANT_PLANS = [
    ((4, 131072 * 64, 64, True), QPlan("vector", 16)),
    ((5, 37696, 256, True), QPlan("vector", 16)),
    ((5, 14136, 256, True), QPlan("vector", 8)),
    ((1000, 21624, 256, True), QPlan("vector", 8)),
    ((3, 64036, 64, True), QPlan("vector", 4)),
    ((2, 456, 16, True), QPlan("vector", 8)),
    ((3, 5000, 1024, True), QPlan("vector", 8)),
    ((2, 1000, 40, True), QPlan("scalar", 1)),
    ((2, 1024, 48, True), QPlan("scalar", 1)),
    ((3, 1002, 64, True), QPlan("scalar", 1)),
    ((5, 14136, 256, False), QPlan("scalar", 1)),
    ((65536, 64, 64, True), QPlan("scalar", 1)),
]


@pytest.mark.parametrize("args,plan", QUANT_PLANS, ids=[
    "-".join(map(str, a)) for a, _ in QUANT_PLANS])
def test_quantize_plan(args, plan):
    """The variant and code-store width batched_quantize hands the CUDA
    entry point: the vector variant (a chunk a group of chunk / 16 lanes)
    wherever the chunk is a power of two of at least 16, P % 4 == 0 and the
    base is aligned, storing 16 codes as wide as every row start allows."""
    got = quantize_plan(*args)
    assert got == plan
    C, P, chunk, aligned = args
    if got.variant == "vector":
        assert P % got.store == 0 and chunk % 16 == 0 and aligned
        assert (chunk // 16) & (chunk // 16 - 1) == 0


# (N, M, D, aligned) -> the KL plan: the round's C = 5 and C = 100 on the
# one-launch small tile, the fleet's C = 1000 split (its tile reads the row
# pass's scratch by TMA, rows rounded up to 4, so b's alignment and D do
# not matter there), ragged D (no float4 loads) and a misaligned b, the
# split threshold's two sides
KL_PLANS = [
    ((5, 30, 128, True), KLPlan("small", True, None)),
    ((5, 30, 128, False), KLPlan("small", False, None)),
    ((100, 600, 128, True), KLPlan("small", True, None)),
    ((1000, 6000, 128, True), KLPlan("split", False, (1000, 6000))),
    ((1000, 6000, 128, False), KLPlan("split", False, (1000, 6000))),
    ((1001, 6006, 37, False), KLPlan("split", False, (1004, 6008))),
    ((129, 767, 37, True), KLPlan("small", False, None)),
    ((1, 1, 130, True), KLPlan("small", False, None)),
    ((1408, 1408, 128, True), KLPlan("small", True, None)),
    ((1409, 1409, 128, True), KLPlan("split", False, (1412, 1412))),
]


@pytest.mark.parametrize("args,plan", KL_PLANS, ids=[
    "-".join(map(str, a)) for a, _ in KL_PLANS])
def test_kl_plan(args, plan):
    """kl_similarity's variant, load width and scratch rows: one launch
    (small, 64 x 64 tiles) below ``SPLIT_MIN_TILES`` tiles of 128 x 128,
    the row pass and 128 x 128 tiles from there."""
    assert kl_plan(*args) == plan
    N, M, D, _ = args
    tiles = -(-N // 128) * -(-M // 128)
    assert (plan.variant == "split") == (tiles >= SPLIT_MIN_TILES)


KL_TOL = 2e-6    # chip_smoke.py's bar for the kernel against the plain one


def _fma32(a, b, c):
    """fp32 fmaf, emulated: the float64 product of two fp32 values is exact,
    the sum rounds once there and once more to fp32 (equal to fmaf but
    where that double rounding falls on a tie, which does not change the
    orders compared here)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _warp_rows(x, D):
    """The two-launch kernel's row statistics, one warp a row: lane l sums
    columns l, l + 32, .. in order, warp_sum's xor butterfly adds the 32
    lanes (each lane its own value plus its partner's); every lane's
    result is returned, to show they agree. -> (max, sum, h, p)."""
    R = x.shape[0]
    m = x.max(1)
    sh = (x - m[:, None]).astype(np.float32)
    e = np.exp(sh).astype(np.float32)

    def butterfly(terms, fma=None):
        lanes = np.zeros((R, 32), np.float32)
        for d in range(D):
            if fma is None:
                lanes[:, d % 32] = lanes[:, d % 32] + terms[:, d]
            else:
                lanes[:, d % 32] = _fma32(terms[0][:, d], terms[1][:, d],
                                          lanes[:, d % 32])
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ off]
        assert (lanes == lanes[:, :1]).all()     # every lane agrees
        return lanes[:, 0]

    s = butterfly(e)
    lse = np.log(s).astype(np.float32)
    p = (e / s[:, None]).astype(np.float32)      # IEEE division, rounded
    shift = np.float32(np.log(D))
    h = butterfly(((p, ((sh - lse[:, None]) + shift).astype(np.float32))),
                  fma=True)
    return m, s, h, p


def _tile_rows(x, D, threads):
    """The fused tile's row statistics: ``threads`` threads a row split the
    32 lane partials (thread j takes lanes kB j + 8 (i / kB) + i % kB, kB =
    8 / threads), each summing its lanes' columns in order, and lane_tree
    adds the 32 partials in one thread: v[l] += v[l + off] for off = 16,
    8, 4, 2, then v[0] + v[1]."""
    R = x.shape[0]
    kR, kB = 32 // threads, 8 // threads
    owned = sorted(kB * j + 8 * (i // kB) + i % kB
                   for j in range(threads) for i in range(kR))
    assert owned == list(range(32))              # each lane once
    m = x.max(1)
    sh = (x - m[:, None]).astype(np.float32)
    e = np.exp(sh).astype(np.float32)

    def tree(part):
        v = part.copy()
        for off in (16, 8, 4, 2):
            v[:, :off] = v[:, :off] + v[:, off:2 * off]
        return v[:, 0] + v[:, 1]

    part = np.zeros((R, 32), np.float32)
    for j in range(threads):
        for i in range(kR):
            lane = kB * j + 8 * (i // kB) + i % kB
            for d in range(lane, D, 32):
                part[:, lane] = part[:, lane] + e[:, d]
    s = tree(part)
    lse = np.log(s).astype(np.float32)
    p = (e / s[:, None]).astype(np.float32)
    shift = np.float32(np.log(D))
    q = ((sh - lse[:, None]) + shift).astype(np.float32)
    part[:] = 0.0
    for lane in range(32):
        for d in range(lane, D, 32):
            part[:, lane] = _fma32(p[:, d], q[:, d], part[:, lane])
    return m, s, tree(part), p


@pytest.mark.parametrize("kind", ["tanh", "near_uniform"])
def test_tile_row_statistics_keep_the_warp_order_at_the_fleet_shape(kind):
    """The fused tile's row statistics (the lane partials split over the
    threads of a row, lane_tree in one thread) against the one-warp-a-row
    loop with warp_sum's butterfly, emulated in numpy fp32 at C = 1000 (N
    = 1000 rows of a, D = 128; tanh task features and near-uniform rows,
    where S sits next to 1): max, sum, h and p agree bit for bit, 4
    threads a row (the small tile) as 2. S from those statistics (64 rows
    of a against 600 of b) lies within half of KL_TOL of float64: 4.8e-7
    (tanh) and 6.3e-7 (near-uniform), the fp32 roundings of log(sum) and
    log D, which the shift cannot cancel between two rows."""
    rng = np.random.default_rng(20)
    N, D = 1000, 128
    x = rng.standard_normal((N, D))
    x = np.tanh(x) if kind == "tanh" else 1e-3 * x
    x = x.astype(np.float32)
    want = _warp_rows(x, D)
    for threads in (4, 2):
        got = _tile_rows(x, D, threads)
        for g, w in zip(got, want):
            assert np.array_equal(g.view(np.int32), w.view(np.int32))
    # S for 64 rows of a against 600 of b, from the warp statistics
    m, s, h, p = want
    xb = x[:600]
    mb = xb.max(1)
    lb = np.log(np.exp(xb - mb[:, None]).astype(np.float32).sum(1))
    q = (((xb - mb[:, None]) - lb[:, None].astype(np.float32))
         + np.float32(np.log(D))).astype(np.float32)
    acc = np.zeros((64, 600), np.float32)
    for d in range(D):
        acc = _fma32(p[:64, d][:, None], q[None, :, d], acc)
    S = np.exp(acc - h[:64, None])
    x64 = x.astype(np.float64)
    la = x64 - x64.max(1, keepdims=True)
    la -= np.log(np.exp(la).sum(1, keepdims=True))
    exact = np.exp(np.exp(la[:64]) @ la[:600].T
                   - (np.exp(la[:64]) * la[:64]).sum(1)[:, None])
    assert np.abs(S - exact).max() <= KL_TOL / 2


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: result byte n is byte (sel >>
    4 n) & 7 of the eight bytes of x (0-3) and y (4-7)."""
    pool = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
        [(np.uint32(y) >> np.uint32(8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= pool[(sel >> (4 * n)) & 7].astype(np.uint32) << np.uint32(8 * n)
    return out


def test_dist_tile_widens_int8_codes_exactly():
    """The tile variant widens a word of four int8 codes without I2F (which
    runs at an eighth of the FMA rate): u = w ^ 0x80808080 makes each byte
    code + 128, a byte permute puts it under the exponent of 2^23 (bits
    0x4b0000uu), and one fp32 subtraction of 2^23 + 128 leaves the code,
    exactly. Emulated for every code in every byte position, against
    float(code) bit for bit (0 gives +0, as the cast does)."""
    codes = np.arange(-128, 128, dtype=np.int8)
    for pos in range(4):
        words = np.zeros((256, 4), np.int8)
        words[:, pos] = codes
        words[:, (pos + 1) % 4] = codes[::-1]       # a neighbour in place
        w = words.view(np.uint32)[:, 0]
        u = w ^ np.uint32(0x80808080)
        bits = _byte_perm(u, 0x4B000000, 0x7440 + pos)
        got = bits.view(np.float32) - np.float32(8388736.0)
        assert got.dtype == np.float32
        want = codes.astype(np.float32)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_dist_epilogue_rounding_matches_any_contraction():
    """Both variants write (|q|^2 + n2) - 2 (dot s) (int8) and (|q|^2 + n2)
    - 2 dot (fp32) with explicit roundings: r1 = fl(qq + n2), t = fl(dot
    s), fl(r1 - fl(2 t)). Doubling is exact, so that equals the single
    rounding fl(r1 - 2 t) that nvcc's FMA contraction of the parent's
    expression computes: the new epilogue is bit-identical to the parent's
    however it was contracted. Checked on 10^5 random triples (float64
    holds r1 - 2 t exactly at these magnitudes)."""
    rng = np.random.default_rng(21)
    n = 100_000
    qq = rng.random(n).astype(np.float32)
    n2 = rng.random(n).astype(np.float32)
    dot = rng.uniform(-1, 1, n).astype(np.float32)
    s = rng.uniform(1e-3, 1e-2, n).astype(np.float32) * 100
    r1 = (qq + n2).astype(np.float32)
    for t in (dot, (dot * s).astype(np.float32)):
        explicit = (r1 - (np.float32(2.0) * t).astype(np.float32)).astype(
            np.float32)
        contracted = (r1.astype(np.float64)
                      - 2.0 * t.astype(np.float64)).astype(np.float32)
        assert np.array_equal(explicit.view(np.int32),
                              contracted.view(np.int32))


# (C, B, G, F, mode, aligned) -> the distance kernels' plan: the path
# shapes (serving int8 and fp32, the round's evaluation, the 2-D entry's 64
# x 32768, the IVF cluster distances) and edges of B, G and F on the tile
# variant; rows that are no whole 16 bytes (int8 F 40, fp32 F 37) and
# misaligned bases, the variant chip_smoke.py forces with aligned=False,
# on the ragged one
DIST_PLANS = [
    ((4, 64, 131072, 64, "int8", True), DPlan("tile")),
    ((4, 64, 32768, 64, "fp32", True), DPlan("tile")),
    ((5, 576, 2304, 64, "fp32", True), DPlan("tile")),
    ((1, 64, 32768, 64, "fp32", True), DPlan("tile")),
    ((4, 64, 512, 64, "norms", True), DPlan("tile")),
    ((2, 129, 257, 48, "int8", True), DPlan("tile")),
    ((1, 1, 1, 64, "fp32", True), DPlan("tile")),
    ((2, 65, 255, 64, "norms", True), DPlan("tile")),
    ((3, 7, 1000, 40, "fp32", True), DPlan("tile")),
    ((2, 129, 257, 40, "int8", True), DPlan("ragged")),
    ((3, 7, 1000, 37, "fp32", True), DPlan("ragged")),
    ((2, 3, 100, 0, "fp32", True), DPlan("ragged")),
    ((4, 64, 131072, 64, "int8", False), DPlan("ragged")),
    ((4, 64, 32768, 64, "fp32", False), DPlan("ragged")),
    ((5, 576, 2304, 64, "fp32", False), DPlan("ragged")),
    ((4, 64, 512, 64, "norms", False), DPlan("ragged")),
]


@pytest.mark.parametrize("args,plan", DIST_PLANS, ids=[
    "-".join(map(str, a)) for a, _ in DIST_PLANS])
def test_dist_plan(args, plan):
    """The variant the distance wrappers hand their CUDA entry points: the
    tile variant (64 x 128 output tiles, persistent blocks) wherever the
    rows and bases allow 16-byte copies (fp32 F % 4 == 0, int8 F % 16 ==
    0), else the ragged one (64 x 64 tiles)."""
    got = dist_plan(*args)
    assert got == plan
    C, B, G, F, mode, aligned = args
    width = F * (1 if mode == "int8" else 4)
    assert (got.variant == "tile") == (aligned and F > 0 and width % 16 == 0)
