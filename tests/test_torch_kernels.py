"""The port's plain kernel versions (repro_torch.kernels.ref, reached through
the device dispatch in repro_torch.kernels.ops) against the JAX package's
kernels on the same numpy inputs — its jnp ``ref`` path and its Pallas
kernel in interpret mode.

Tolerances: quantization is bit-exact (IEEE division, round half to even);
distances agree to atol = rtol = 1e-5 (fp32 sums over F in another order).
The CUDA kernels themselves run only on the card: chip_smoke.py holds each
against these plain versions there.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro_torch.kernels import ops, ref
from repro_torch.kernels.int8_dist import batched_int8_pairwise_dist
from repro_torch.kernels.pairwise_dist import batched_pairwise_dist
from repro_torch.kernels.quantize import batched_quantize

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


KERNEL_CALLS = [
    (batched_quantize, lambda: (torch.zeros(2, 64),)),
    (batched_int8_pairwise_dist,
     lambda: (torch.zeros(1, 2, 8), torch.zeros(1, 3, 8, dtype=torch.int8),
              torch.ones(1, 3), torch.zeros(1, 3))),
    (batched_pairwise_dist, lambda: (torch.zeros(1, 2, 8),
                                     torch.zeros(1, 3, 8))),
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
