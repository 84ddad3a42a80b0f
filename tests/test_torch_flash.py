"""Flash attention in the port: the plain versions of its four stages
(``repro_torch.kernels.ref``) and ``ops.flash_attention``'s autograd
Function on the CPU, against the JAX package's oracles on the same numpy
inputs. The reference's Pallas flash kernels do not run on this JAX (they
call ``pl.load``), so the oracles are ``repro.kernels.ref.
flash_attention_ref`` with its ``jax.grad``, and the model path's
``repro.models.layers.chunked_attention``.

Tolerances: fp32 2e-5 and bf16 2e-2 for the output and the logsumexp
(``tests/test_kernels.py``'s bars: fp32 softmax rows summed in another
order; bf16 one rounding of the output), 5e-4 for gradients
(``tests/test_kernels_bwd.py``'s bar), 2e-5 against ``chunked_attention``
(fp32, its 1024-key chunks). The CUDA kernels run only on the card:
``chip_smoke.py`` holds each against these plain versions there. The
bf16 tensor-core arithmetic of the forward (``csrc/flash_fwd_sm90.cu``)
and of dQ and dK/dV (``csrc/flash_bwd_sm90.cu``) is emulated here and
held to the plain versions at the card's bf16 bars.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.models.layers import chunked_attention
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# chip_smoke.py's bf16 bars: each element within one bf16 rounding of the
# plain version's (2^-7 |b|, floor 1e-3 rms(b)), relative L2, lse absolute
BF16_ULP, BF16_FLOOR, BF16_REL_L2, BF16_LSE_TOL = 2.0 ** -7, 1e-3, 1e-3, 1e-4
GRAD_TOL = 5e-4
CHUNKED_TOL = 2e-5


def _qkv(seed, B, H, sq, sk, hd, hkv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, hkv or H, sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, hkv or H, sk, hd)).astype(np.float32)
    return q, k, v


def _both(x, dtype):
    """numpy fp32 -> (torch, jax) arrays of ``dtype``, rounded once."""
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(dtype))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _jax_lse(q, k, causal):
    """The logsumexp of ``JREF.flash_attention_ref``'s masked logits."""
    hd = q.shape[-1]
    logits = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32),
                        k.astype(jnp.float32)) / jnp.sqrt(hd).astype(
                            jnp.float32)
    if causal:
        sq, sk = logits.shape[-2:]
        mask = jnp.arange(sk)[None, :] <= jnp.arange(sq)[:, None] + sk - sq
        logits = jnp.where(mask, logits, -1e30)
    return jax.nn.logsumexp(logits, axis=-1)


FWD_CASES = [(2, 4, 128, 128, 64, True), (2, 4, 128, 128, 64, False),
             (1, 2, 96, 96, 128, True), (1, 2, 96, 96, 128, False),
             (1, 3, 40, 72, 64, False), (1, 2, 72, 33, 128, False),
             (2, 1, 1, 1, 64, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,sq,sk,hd,causal", FWD_CASES)
def test_forward_and_lse_match_jax_ref(B, H, sq, sk, hd, causal, dtype):
    q, k, v = _qkv(sq * 7 + sk, B, H, sq, sk, hd)
    (tq, jq), (tk, jk), (tv, jv) = (_both(x, dtype) for x in (q, k, v))
    want = _np(JREF.flash_attention_ref(jq, jk, jv, causal=causal))
    o = ops.flash_attention(tq, tk, tv, causal=causal)
    o2, lse = ops.flash_attention_fwd_lse(tq, tk, tv, causal=causal)
    assert o.dtype == tq.dtype and o2.dtype == tq.dtype
    assert lse.dtype == torch.float32 and lse.shape == (B, H, sq)
    np.testing.assert_allclose(_np(o), want, atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(o, o2)
    np.testing.assert_allclose(lse.numpy(), _np(_jax_lse(jq, jk, causal)),
                               atol=TOL[dtype], rtol=TOL[dtype])


GRAD_CASES = [(1, 2, 64, 64, 64, True), (1, 2, 64, 64, 64, False),
              (2, 1, 50, 50, 128, True), (1, 2, 40, 56, 64, False)]


def _jax_grads(q, k, v, do, causal):
    f = lambda q, k, v: jnp.sum(JREF.flash_attention_ref(
        q, k, v, causal=causal) * do)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("B,H,sq,sk,hd,causal", GRAD_CASES)
def test_autograd_function_grads_match_jax(B, H, sq, sk, hd, causal):
    q, k, v = _qkv(sq + 3 * sk + hd, B, H, sq, sk, hd)
    do = np.random.default_rng(1).standard_normal((B, H, sq, hd)).astype(
        np.float32)
    want = _jax_grads(*(jnp.asarray(x) for x in (q, k, v, do)), causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal)
    assert o.grad_fn is not None and "FlashAttention" in type(
        o.grad_fn).__name__
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("B,H,sq,sk,hd,causal", GRAD_CASES)
def test_plain_dq_dkv_stages_match_jax(B, H, sq, sk, hd, causal):
    """The plain dQ and dK/dV stages fed the forward's lse and delta =
    rowsum(O dO), as the kernels are."""
    q, k, v = _qkv(sq * 5 + sk, B, H, sq, sk, hd)
    do = np.random.default_rng(2).standard_normal((B, H, sq, hd)).astype(
        np.float32)
    want = _jax_grads(*(jnp.asarray(x) for x in (q, k, v, do)), causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = ref.flash_attention_fwd_lse_ref(tq, tk, tv, causal=causal)
    delta = torch.sum(o * tdo, -1)
    dq = ref.flash_attention_dq_ref(tq, tk, tv, tdo, lse, delta,
                                    causal=causal)
    dk, dv = ref.flash_attention_dkv_ref(tq, tk, tv, tdo, lse, delta,
                                         causal=causal)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("S", [16, 1000])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("R", [1, 2, 4])
def test_gqa_window_matches_chunked_attention(R, window, S):
    """The model path's layout: q (B, S, KVg, R, hd) heads g * R + r read
    kv head g; causal from q0 = k0 = 0, a sliding window."""
    B, kvg, hd = 1, 2, 64
    rng = np.random.default_rng(R * 100 + window * 10 + S)
    q = rng.standard_normal((B, S, kvg, R, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kvg, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kvg, hd)).astype(np.float32)
    want = np.asarray(chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q0=0, k0=0))                       # (B, S, H, hd)
    tq = torch.from_numpy(q).reshape(B, S, kvg * R, hd).transpose(1, 2)
    tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (k, v))
    o = ops.flash_attention(tq.contiguous(), tk.contiguous(),
                            tv.contiguous(), causal=True, window=window)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), want,
                               atol=CHUNKED_TOL, rtol=CHUNKED_TOL)


def test_gqa_grads_equal_grads_of_repeated_kv():
    """dK/dV of a kv head sum over its R q heads: the same as attention
    over kv repeated to every q head, then summed back."""
    q, k, v = _qkv(11, 1, 4, 24, 24, 64, hkv=2)
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(tq, tk, tv, causal=True),
                              (tq, tk, tv), torch.from_numpy(do))
    want = _jax_grads(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=1),
                      jnp.repeat(jnp.asarray(v), 2, axis=1), jnp.asarray(do),
                      True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w).reshape(1, 2, 2, 24, 64).sum(2)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_causal_convention_is_top_left():
    """The port's causal mask is kpos <= qpos aligned top-left, the Pallas
    kernels' rule and ``chunked_attention``'s with q0 = k0 = 0; the JAX
    ref aligns bottom-right. With Sq = Sk, the case ``attention_block``
    sends, all three agree; with Sq < Sk the JAX ref differs."""
    B, H, hd = 1, 2, 64
    for sq, sk in ((32, 32), (16, 48)):
        q, k, v = _qkv(sq + sk, B, H, sq, sk, hd)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        o = ops.flash_attention(tq, tk, tv, causal=True).numpy()
        top_left = np.asarray(chunked_attention(
            jnp.asarray(q.transpose(0, 2, 1, 3)[:, :, :, None]),
            jnp.asarray(k.transpose(0, 2, 1, 3)),
            jnp.asarray(v.transpose(0, 2, 1, 3)),
            causal=True, window=0, q0=0, k0=0)).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(o, top_left, atol=CHUNKED_TOL,
                                   rtol=CHUNKED_TOL)
        bottom_right = np.asarray(JREF.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
        if sq == sk:
            np.testing.assert_allclose(o, bottom_right, atol=TOL["float32"],
                                       rtol=TOL["float32"])
        else:
            assert np.abs(o - bottom_right).max() > 0.1
    # the first query sees only key 0: its output is v[0] exactly
    np.testing.assert_array_equal(o[:, :, 0], v[:, :, 0])


def test_forward_stage_without_grad_and_function_with():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 2, 8, 8, 64))
    assert ops.flash_attention(q, k, v, causal=True).grad_fn is None
    with torch.no_grad():
        qg = q.clone().requires_grad_()
        assert ops.flash_attention(qg, k, v, causal=True).grad_fn is None
    qg = q.clone().requires_grad_()
    assert ops.flash_attention(qg, k, v, causal=True).grad_fn is not None


def test_row_with_no_visible_key_is_zero():
    """Non-causal with a window and Sq > Sk: the last queries see no key;
    their output is 0 and lse -1e30 (the plain version and the kernels
    alike; no causal call has such a row)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 1, 1, 12, 4, 64))
    o, lse = ops.flash_attention_fwd_lse(q, k, v, causal=False, window=3)
    assert torch.all(o[0, 0, 6:] == 0) and torch.all(lse[0, 0, 6:] <= -1e29)
    assert torch.all(o[0, 0, :6].abs().sum(-1) > 0)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers check their operands before any build or launch:
    CPU tensors, head dims above 128 (the kernels run at 64 or 128, any
    smaller hd zero-padded up), q heads that are not a multiple of kv
    heads, mixed dtypes."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 4, 8, 8, 64, hkv=2))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_fwd(q, k, v, causal=True)
    q160, k160, v160 = (torch.from_numpy(x)
                        for x in _qkv(1, 1, 2, 8, 8, 160))
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_fwd_lse(q160, k160, v160, causal=True)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention_fwd(q[:, :3].contiguous(), k, v, causal=True)
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q.double(), k, v, causal=True)
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_dkv(q, k, v, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_dq(q, k, v, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_dq(q160, k160, v160, q160, lse[:, :2], lse[:, :2],
                              causal=True)
    for fn in (FA.flash_attention_fwd, FA.flash_attention_fwd_lse,
               FA.flash_attention_dq, FA.flash_attention_dkv):
        assert fn.launches == 0 and fn.tc_launches == 0


@pytest.mark.parametrize("hd,kernel_hd", [(32, 64), (64, 64), (80, 128),
                                           (128, 128)])
def test_head_dims_pad_to_the_kernels_with_their_own_scale(hd, kernel_hd):
    """The wrappers run a head dim the kernels are not built for (zamba2's
    80) zero-padded to 64 or 128, with the softmax scale of the true hd:
    the padded q k^T equals the unpadded one, so attention over the padded
    operands, cut back to hd, is the plain version's."""
    from repro_torch.kernels import flash_attention as FA
    assert FA.kernel_head_dim(hd) == kernel_hd
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 4, 9, 11, hd, hkv=2))
    qp, kp, vp = FA._padded(hd, q, k, v)
    assert qp.shape[-1] == kernel_hd and torch.equal(qp[..., :hd], q)
    assert not qp[..., hd:].any() and not vp[..., hd:].any()
    s = (qp * (1.0 / np.sqrt(hd))) @ kp.repeat_interleave(2, 1).transpose(
        -1, -2)
    mask = ref.flash_mask(9, 11, causal=False, window=0, device="cpu")
    p = torch.softmax(torch.where(mask, s, ref.FLASH_NEG_INF), -1)
    o = FA._unpadded(hd, p @ vp.repeat_interleave(2, 1))
    want = ref.flash_attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(o.numpy(), want.numpy(), atol=TOL["float32"],
                               rtol=TOL["float32"])


def _emulate_tc_forward(q, k, v, *, causal, window, split=True, bk=128):
    """The tensor-core forward's arithmetic in PyTorch on the CPU: bf16 q,
    k, v; S in fp32 from the exact bf16 products, the scale applied after
    the product (with log2 e, ahead of exp2); an online softmax over kv
    tiles of ``bk``; P split into bf16 hi + lo (``split``) or rounded once;
    fp32 accumulation; l summed from the unrounded P. -> (o bf16, lse)."""
    B, hq, sq, hd = q.shape
    sk, r = k.shape[2], hq // k.shape[1]
    kf, vf = (x.float().repeat_interleave(r, 1) for x in (k, v))
    c2 = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32) * \
        torch.tensor(np.log2(np.e), dtype=torch.float32)
    mask = ref.flash_mask(sq, sk, causal=causal, window=window,
                          device=q.device)
    m = torch.full((B, hq, sq), ref.FLASH_NEG_INF)
    l = torch.zeros((B, hq, sq))
    acc = torch.zeros((B, hq, sq, hd))
    for k0 in range(0, sk, bk):
        vis = mask[:, k0:k0 + bk]
        s = torch.where(vis, q.float() @ kf[:, :, k0:k0 + bk].transpose(
            -1, -2), -torch.inf)
        m_new = torch.maximum(m, s.amax(-1) * c2)
        p = torch.where(vis, torch.exp2(s * c2 - m_new[..., None]), 0.0)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[:, :, k0:k0 + bk]
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
        acc = acc * corr[..., None] + pv
        m = m_new
    lc = l.clamp(min=1e-30)
    lse = torch.where(l > 0, m * float(np.log(2.0)) + torch.log(lc),
                      ref.FLASH_NEG_INF)
    return (acc / lc[..., None]).to(torch.bfloat16), lse


def _bf16_readings(a, b):
    """(largest share of the element bar, relative L2) of ``a`` against
    ``b``."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    bar = BF16_ULP * b.abs() + BF16_FLOOR * torch.sqrt(torch.mean(b * b))
    return (float((diff / bar).max()),
            float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(b)))


TC_CASES = [(1, 2, 1, 200, 200, 64, True, 0),      # R 2, ragged
            (1, 2, 2, 200, 200, 128, True, 0),     # R 1, ragged
            (1, 2, 2, 300, 300, 128, True, 37),    # causal window
            (1, 4, 2, 130, 77, 128, False, 0),     # Sq != Sk
            (1, 2, 1, 130, 77, 64, False, 5),      # rows that see no key
            (1, 2, 1, 77, 130, 128, False, 5),
            (1, 2, 1, 256, 256, 64, False, 0),
            (1, 2, 1, 77, 130, 64, True, 0)]      # kv rows no query sees


@pytest.mark.parametrize("B,hq,hkv,sq,sk,hd,causal,window", TC_CASES)
def test_tensor_core_forward_arithmetic_meets_the_bf16_bars(
        B, hq, hkv, sq, sk, hd, causal, window):
    """P split into bf16 hi + lo keeps the tensor-core forward within one
    bf16 rounding of the fp32 plain version, element by element."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(
        sq * 3 + sk + hd + window, B, hq, sq, sk, hd, hkv=hkv))
    o, lse = _emulate_tc_forward(q, k, v, causal=causal, window=window)
    o_ref, lse_ref = ref.flash_attention_fwd_lse_ref(q, k, v, causal=causal,
                                                     window=window)
    elem, rel_l2 = _bf16_readings(o, o_ref)
    assert elem <= 1.0 and rel_l2 <= BF16_REL_L2, (elem, rel_l2)
    assert float((lse - lse_ref).abs().max()) <= BF16_LSE_TOL
    blind = ref.flash_mask(sq, sk, causal=causal, window=window,
                           device="cpu").sum(-1) == 0
    assert torch.all(o[:, :, blind] == 0)
    assert torch.all(lse[:, :, blind] == ref.FLASH_NEG_INF)


def test_single_rounded_p_misses_the_element_bar():
    """Why the kernel splits P: at S 1024, hd 128, causal, P rounded once
    to bf16 (FA2, FA3, SDPA) lands several bf16 roundings away from the
    plain version somewhere; the split stays within one."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(17, 1, 4, 1024, 1024, 128))
    o_ref = ref.flash_attention_ref(q, k, v, causal=True)
    split = _bf16_readings(_emulate_tc_forward(q, k, v, causal=True,
                                               window=0)[0], o_ref)
    once = _bf16_readings(_emulate_tc_forward(q, k, v, causal=True, window=0,
                                              split=False)[0], o_ref)
    assert split[0] <= 1.0 and split[1] <= BF16_REL_L2, split
    assert once[0] > 1.0, once


def test_forwards_pick_their_kernel_by_dtype():
    """bf16 goes to the tensor-core kernels, fp32 to the FMA kernels, for
    the forwards and for dQ and dK/dV alike; all four refuse CPU tensors
    before any build, counting nothing."""
    from repro_torch.kernels import flash_attention as FA
    assert FA.uses_tensor_cores(torch.bfloat16)
    assert not FA.uses_tensor_cores(torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(x).to(dtype)
                   for x in _qkv(2, 1, 2, 8, 8, 128))
        for fn in (FA.flash_attention_fwd, FA.flash_attention_fwd_lse):
            with pytest.raises(ValueError, match="CUDA"):
                fn(q, k, v, causal=True)
            assert fn.launches == 0 and fn.tc_launches == 0
        lse = torch.zeros((1, 2, 8))
        for fn in (FA.flash_attention_dq, FA.flash_attention_dkv):
            with pytest.raises(ValueError, match="CUDA"):
                fn(q, k, v, q, lse, lse, causal=True)
            assert fn.launches == 0 and fn.tc_launches == 0


def _emulate_tc_backward(q, k, v, do, lse, delta, *, causal, window,
                         split=True, tile=64):
    """The tensor-core dQ and dK/dV arithmetic in PyTorch on the CPU: bf16
    q, k, v, dO; S and dP in fp32 from the exact bf16 products; P =
    exp2(S scale log2 e - lse log2 e) (the scale after the product) and dS
    = P (dP - delta) scale, each 0 where the pair is masked (a select:
    a row that sees no key has lse -1e30); P and dS split into bf16 hi +
    lo (``split``) or rounded once; fp32 accumulation tile by tile (dQ
    over kv tiles of ``tile``; dK and dV over the R q heads in turn, q
    tiles of ``tile`` each). -> (dq, dk, dv) bf16."""
    B, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    r = hq // hkv
    kf, vf = (x.float().repeat_interleave(r, 1) for x in (k, v))
    log2e = torch.tensor(np.log2(np.e), dtype=torch.float32)
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    mask = ref.flash_mask(sq, sk, causal=causal, window=window,
                          device=q.device)
    s = q.float() @ kf.transpose(-1, -2)
    p = torch.where(mask, torch.exp2(s * (scale * log2e)
                                     - (lse * log2e)[..., None]), 0.0)
    dp = do.float() @ vf.transpose(-1, -2)
    ds = torch.where(mask, p * (dp - delta[..., None]) * scale, 0.0)

    def parts(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    dq = torch.zeros((B, hq, sq, hd))
    for k0 in range(0, sk, tile):
        for part in parts(ds[..., k0:k0 + tile]):
            dq = dq + part @ kf[:, :, k0:k0 + tile]
    pg, dsg, qg, dog = (x.reshape(B, hkv, r, *x.shape[2:])
                        for x in (p, ds, q.float(), do.float()))
    dk = torch.zeros((B, hkv, sk, hd))
    dv = torch.zeros((B, hkv, sk, hd))
    for i in range(r):
        for q0 in range(0, sq, tile):
            rows = slice(q0, q0 + tile)
            for part in parts(pg[:, :, i, rows]):
                dv = dv + part.transpose(-1, -2) @ dog[:, :, i, rows]
            for part in parts(dsg[:, :, i, rows]):
                dk = dk + part.transpose(-1, -2) @ qg[:, :, i, rows]
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _backward_case(seed, B, hq, hkv, sq, sk, hd, causal, window):
    """bf16 q, k, v, dO from ``seed``, the plain forward's lse and delta =
    rowsum(O dO), and the plain dQ, dK, dV on them."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(
        seed, B, hq, sq, sk, hd, hkv=hkv))
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16)
    kw = dict(causal=causal, window=window)
    o, lse = ref.flash_attention_fwd_lse_ref(q, k, v, **kw)
    delta = torch.sum(o.float() * do.float(), -1)
    want = (ref.flash_attention_dq_ref(q, k, v, do, lse, delta, **kw),
            *ref.flash_attention_dkv_ref(q, k, v, do, lse, delta, **kw))
    return (q, k, v, do, lse, delta), want


@pytest.mark.parametrize("B,hq,hkv,sq,sk,hd,causal,window", TC_CASES)
def test_tensor_core_backward_arithmetic_meets_the_bf16_bars(
        B, hq, hkv, sq, sk, hd, causal, window):
    """P and dS split into bf16 hi + lo keep the tensor-core dQ, dK and dV
    within one bf16 rounding of the fp32 plain versions, element by
    element; rows that see no key get dQ 0 and kv rows that no query sees
    dK and dV 0, exactly."""
    args, want = _backward_case(sq * 5 + sk + hd + window, B, hq, hkv, sq,
                                sk, hd, causal, window)
    got = _emulate_tc_backward(*args, causal=causal, window=window)
    for a, b in zip(got, want):
        elem, rel_l2 = _bf16_readings(a, b)
        assert elem <= 1.0 and rel_l2 <= BF16_REL_L2, (elem, rel_l2)
    mask = ref.flash_mask(sq, sk, causal=causal, window=window, device="cpu")
    dq, dk, dv = got
    assert torch.all(dq[:, :, mask.sum(-1) == 0] == 0)
    unseen = mask.sum(0) == 0
    assert torch.all(dk[:, :, unseen] == 0) and torch.all(dv[:, :, unseen] == 0)


def test_single_rounded_p_and_ds_miss_the_element_bar():
    """Why the backward splits P and dS: at S 1024, hd 128, causal, P and
    dS rounded once to bf16 (FA2, FA3, SDPA) land several bf16 roundings
    away from the plain versions somewhere in dQ, dK and dV; the split
    stays within one."""
    args, want = _backward_case(19, 1, 4, 2, 1024, 1024, 128, True, 0)
    split = _emulate_tc_backward(*args, causal=True, window=0)
    once = _emulate_tc_backward(*args, causal=True, window=0, split=False)
    for a, b in zip(split, want):
        elem, rel_l2 = _bf16_readings(a, b)
        assert elem <= 1.0 and rel_l2 <= BF16_REL_L2, (elem, rel_l2)
    for a, b in zip(once, want):
        assert _bf16_readings(a, b)[0] > 1.0
