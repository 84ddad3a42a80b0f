"""The decode attention: ``ops.decode_attention``, ``csrc/decode_attention.cu``.

On the CPU: the [lo, hi) range that ``layers.decode_slot_range`` gives
equals the boolean masks the einsum path built (causal, window, ring before
and after it wraps, cross with ``kv_len``, TP ranks); the plain version,
and ``layers.decode_attention`` through it, against that einsum path
written out below, over mask kinds x cache dtypes x R x hd; ``_plan``'s
splits.

On the card (marker ``card``; ``PYTHONPATH=src python -m pytest -q -m card
tests/test_torch_decode_attention.py``): the kernel against the plain
version in the cache's dtype at both decode cells' shapes, ragged chunk
edges, an empty TP range, every hd and R of ``configs/`` and their
``reduced()`` forms, stacked-layer and strided views; a decode step's
launches, and no call of the plain version or of a library attention.
"""
import dataclasses
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.models import layers as L
from repro_torch.models import lm

# name: (S local, tp size, tp index, pos, window, inject, kv_len, ring)
KINDS = {
    "causal": (40, 1, 0, 25, 0, True, None, 0),
    "window": (40, 1, 0, 30, 8, True, None, 0),
    "ring_before_wrap": (16, 1, 0, 9, 0, True, None, 16),
    "ring_after_wrap": (16, 1, 0, 37, 0, True, None, 16),
    "cross_kv_len": (24, 1, 0, 5, 0, False, 13, 0),
    "tp_rank_full": (20, 2, 0, 31, 0, True, None, 0),
    "tp_rank_partial": (20, 2, 1, 31, 0, True, None, 0),
    "tp_rank_empty": (20, 2, 1, 12, 0, True, None, 0),
}
UNSHARDED_KINDS = [k for k in KINDS if not k.startswith("tp_")]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
RS = (1, 2, 4)
HDS = (64, 128)
B, KV = 2, 2


# ---------------------------------------------------------------------------
# the einsum path this kernel replaced (layers.decode_attention before it)
# ---------------------------------------------------------------------------


def einsum_valid(S, tp_size, tp_idx, pos, window, inject, kv_len, ring):
    """The boolean mask over the rank's S slots."""
    kpos = tp_idx * S + torch.arange(S)
    if not inject:
        return kpos < (kv_len if kv_len is not None else S * tp_size)
    if ring:
        return (kpos <= pos) | (pos >= ring)
    valid = kpos <= pos
    if window > 0:
        valid = valid & (kpos > pos - window)
    return valid


def einsum_attention(q, k_eff, v_eff, valid):
    """(o unnormalized, m, l) over the whole cache, masked slots at -1e30."""
    hd = q.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bgrh,bkgh->bgrk", qf, k_eff.float())
    s = torch.where(valid, s, -1e30)
    m = torch.amax(s, -1)
    pr = torch.exp(s - m[..., None])
    l = torch.sum(pr, -1)
    o = torch.einsum("bgrk,bkgh->bgrh", pr, v_eff.float())
    return o, m, l


def einsum_layer(cfg, p, x, cache, pos, *, window=0, inject=True,
                 kv_len=None, ring_window=0):
    """The whole unsharded layer as it was: projection, the cache write,
    the cache into fp32 (dequantized when int8), the einsum attention."""
    B_, hd, kv = x.shape[0], cfg.hd, cfg.n_kv_heads
    S = cache["k"].shape[1]
    quantized = cache["k"].dtype == torch.int8
    at = torch.full((B_, 1), pos, dtype=torch.long)
    q, k_new, v_new = L._project_qkv(cfg, p, x, x, L.UNSHARDED, at, at)
    if inject:
        slot = pos % ring_window if ring_window else pos
        if 0 <= slot < S:
            if quantized:
                kq, ks = L._quantize_kv(k_new)
                vq, vs = L._quantize_kv(v_new)
                L._cache_write(cache, ("k", "v", "k_scale", "v_scale"),
                               (kq, vq, ks, vs), slot)
            else:
                L._cache_write(cache, ("k", "v"), (k_new, v_new), slot)
    if quantized:
        k_eff = L._dequantize_kv(cache["k"], cache["k_scale"])
        v_eff = L._dequantize_kv(cache["v"], cache["v_scale"])
    else:
        k_eff, v_eff = cache["k"].float(), cache["v"].float()
    valid = einsum_valid(S, 1, 0, pos, window, inject, kv_len, ring_window)
    hp = q.shape[2] * q.shape[3]
    o, m, l = einsum_attention(q.reshape(B_, kv, hp // kv, hd), k_eff, v_eff,
                               valid)
    return (o / torch.clamp(l, min=1e-30)[..., None]).reshape(B_, 1, hp, hd)


def _range(kind):
    S, tp, idx, pos, window, inject, kv_len, ring = KINDS[kind]
    return L.decode_slot_range(S, idx, tp, pos, window=window, inject=inject,
                               kv_len=kv_len, ring_window=ring)


def _close(a, b):
    """fp32 sums of up to 40 terms in another order: within 1e-6 of the
    largest |b| (a partial o's terms reach l |v|, far above o itself)."""
    torch.testing.assert_close(a, b, rtol=1e-5,
                               atol=1e-6 * float(b.abs().max()))


def _operands(kind, dtype, R, hd, seed=0):
    S = KINDS[kind][0]
    g = torch.Generator().manual_seed(seed)
    q = 2.0 * torch.randn((B, KV, R, hd), generator=g)
    k = torch.randn((B, S, KV, hd), generator=g).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(dtype)
    return q, k, v


# ---------------------------------------------------------------------------
# the range against the masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_slot_range_equals_the_einsum_mask(kind):
    """The kind's own range, then every position from before the cache to
    three caches past it, on every rank of worlds of 1, 2 and 4 ranks, with
    the kind's window, ring and kv_len: the range's slots are the mask."""
    S, _, _, _, window, inject, kv_len, ring = KINDS[kind]
    lo, hi = _range(kind)
    assert 0 <= lo <= hi <= S
    for tp in (1, 2, 4):
        for idx in range(tp):
            for pos in range(0, 3 * S * tp + 2):
                want = einsum_valid(S, tp, idx, pos, window, inject, kv_len,
                                    ring)
                lo, hi = L.decode_slot_range(S, idx, tp, pos, window=window,
                                             inject=inject, kv_len=kv_len,
                                             ring_window=ring)
                got = (torch.arange(S) >= lo) & (torch.arange(S) < hi)
                assert torch.equal(got, want), (tp, idx, pos, lo, hi)


def test_slot_range_kinds_are_what_they_say():
    assert _range("tp_rank_full") == (0, 20)
    assert _range("tp_rank_partial") == (0, 12)
    assert _range("tp_rank_empty") == (0, 0)
    assert _range("window") == (23, 31)
    assert _range("ring_before_wrap") == (0, 10)
    assert _range("ring_after_wrap") == (0, 16)
    assert _range("cross_kv_len") == (0, 13)


# ---------------------------------------------------------------------------
# the plain version against the einsum path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_version_equals_the_einsum_path(kind, dtype, R, hd):
    """fp32 on both sides; only the slots past the range differ, which the
    einsum path weighs by exp(-1e30 - m) = 0: the same numbers up to the
    order of the sums. A TP rank's partial (o, m, l); an empty rank's is
    (0, -1e30, 0) where the einsum path's l counted every masked slot, and
    both merge to nothing beside a rank that sees a slot."""
    q, k, v = _operands(kind, DTYPES[dtype], R, hd)
    S, tp, idx, pos, window, inject, kv_len, ring = KINDS[kind]
    valid = einsum_valid(S, tp, idx, pos, window, inject, kv_len, ring)
    lo, hi = _range(kind)
    o_w, m_w, l_w = einsum_attention(q, k, v, valid)
    if tp == 1:
        got = ops.decode_attention(q, k, v, lo, hi)
        _close(got, o_w / torch.clamp(l_w, min=1e-30)[..., None])
        return
    o, m, l = ops.decode_attention(q, k, v, lo, hi, partial=True)
    assert o.dtype == m.dtype == l.dtype == torch.float32
    if hi > lo:
        for a, b in ((o, o_w), (m, m_w), (l, l_w)):
            _close(a, b)
        return
    assert torch.all(m == -1e30) and torch.all(m_w == -1e30)
    assert torch.all(l == 0) and torch.all(o == 0)
    # the merge beside rank 0 (every slot of it seen)
    o0, m0, l0 = ops.decode_attention(q, k, v, 0, S, partial=True)
    for oe, me, le in ((o, m, l), (o_w, m_w, l_w)):
        mx = torch.maximum(m0, me)
        c0, ce = torch.exp(m0 - mx), torch.exp(me - mx)
        merged = (o0 * c0[..., None] + oe * ce[..., None]) \
            / (l0 * c0 + le * ce)[..., None]
        torch.testing.assert_close(merged, o0 / l0[..., None], rtol=0,
                                   atol=0)


def test_plain_version_refuses_an_empty_unsharded_range():
    q, k, v = _operands("causal", torch.float32, 1, 64)
    with pytest.raises(ValueError, match="no valid slot"):
        ops.decode_attention(q, k, v, 7, 7)
    with pytest.raises(ValueError, match="outside"):
        ops.decode_attention(q, k, v, 0, 41)


def test_meta_operands_give_shapes():
    q = torch.empty((2, 4, 2, 64), device="meta")
    k = torch.empty((2, 512, 4, 64), dtype=torch.bfloat16, device="meta")
    o = ops.decode_attention(q, k, k, 0, 500)
    assert o.device.type == "meta" and o.shape == (2, 4, 2, 64)
    o, m, l = ops.decode_attention(q, k, k, 3, 3, partial=True)
    assert m.shape == l.shape == (2, 4, 2) and o.dtype == torch.float32


# ---------------------------------------------------------------------------
# layers.decode_attention through it
# ---------------------------------------------------------------------------

LAYER_DTYPES = dict(DTYPES, int8=torch.int8)


def _layer_setup(R, hd, cache_dtype, kind, seed=3):
    S, _, _, pos, window, inject, kv_len, ring = KINDS[kind]
    base = get_config("qwen3-1.7b").reduced()
    cfg = dataclasses.replace(base, n_heads=4, n_kv_heads=4 // R,
                              head_dim=hd)
    g = torch.Generator().manual_seed(seed)
    p = L.attention_params(g, cfg)
    x = torch.randn((B, 1, cfg.d_model), generator=g)
    cache = L.init_kv_cache(cfg, B, S, cache_dtype)
    full = torch.randn((2, B, S, cfg.n_kv_heads, hd), generator=g)
    if cache_dtype == torch.int8:
        for i, name in enumerate(("k", "v")):
            codes, scales = L._quantize_kv(full[i])
            cache[name].copy_(codes)
            cache[name + "_scale"].copy_(scales)
    else:
        cache["k"].copy_(full[0])
        cache["v"].copy_(full[1])
    kw = dict(window=window, inject=inject, kv_len=kv_len, ring_window=ring)
    return cfg, p, x, cache, pos, kw


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("dtype", list(LAYER_DTYPES))
@pytest.mark.parametrize("kind", UNSHARDED_KINDS)
def test_layer_equals_the_einsum_layer(kind, dtype, R, hd):
    """``layers.decode_attention`` (the plain version on the CPU) against
    the layer as it was, on copies of one cache: the same output and the
    same cache after the write."""
    cfg, p, x, cache, pos, kw = _layer_setup(R, hd, LAYER_DTYPES[dtype],
                                             kind)
    mine = {n: t.clone() for n, t in cache.items()}
    got = L.decode_attention(cfg, p, x, mine, pos, **kw)
    want = einsum_layer(cfg, p, x, cache, pos, **kw)
    assert got.shape == want.shape == (B, 1, cfg.n_heads, hd)
    _close(got, want)
    for n in cache:
        assert torch.equal(mine[n], cache[n]), n


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 1, 127, 255, 256, 1000, 32512, 32768,
                                    524288])
@pytest.mark.parametrize("shape", [(8, 16, 1, 64, 2), (8, 8, 2, 128, 2),
                                   (1, 32, 1, 80, 2), (2, 8, 16, 128, 4),
                                   (2, 8, 7, 128, 2), (4, 4, 3, 64, 4)])
def test_plan_covers_the_range(shape, length):
    """Splits cover [lo, hi) exactly once, every split non-empty, each a
    whole number of a block's passes; heads and lanes by R and hd."""
    Bp, KVp, R, hd, item = shape
    plan = DA._plan(Bp, KVp, R, hd, length, item, 132)
    assert plan.heads == (R if R <= 2 else 4)
    assert plan.lanes == (8 if hd <= 64 else 16)
    if length == 0:
        assert (plan.nsplit, plan.chunk) == (1, 0)
        return
    unroll = 2 if plan.heads == 4 or item == 4 else 4
    assert plan.chunk % (DA.THREADS // plan.lanes * unroll) == 0
    assert plan.nsplit * plan.chunk >= length
    assert (plan.nsplit - 1) * plan.chunk < length
    assert 1 <= plan.nsplit <= DA.MAX_SPLITS
    assert plan.nsplit == 1 or plan.chunk >= DA.MIN_CHUNK


@pytest.mark.parametrize("kv, R, hd", [(16, 1, 64), (8, 2, 128)])
def test_plan_fills_the_card_at_the_decode_cells(kv, R, hd):
    """B 8 against 32256-32768 valid slots: tens of splits, the grid the
    SMs' count times ``BLOCKS_PER_SM`` or more."""
    for length in (32257, 32768):
        plan = DA._plan(8, kv, R, hd, length, 2, 132)
        blocks = 8 * kv * plan.nsplit
        assert plan.nsplit >= 10
        assert blocks >= 132 * DA.BLOCKS_PER_SM * 0.9


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# kernel vs plain version, both from the same cache on the card: fp32 sums
# in another order (the plain version's cuBLAS products against the
# kernel's lane, group and split sums) over up to 32768 slots
CARD_TOL = 2e-5          # max |kernel - plain| / max |plain|
CELLS = {"qwen1.5-0.5b": (16, 1, 64), "qwen3-1.7b": (8, 2, 128)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_operands(dev, Bc, S, kv, R, hd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = 2.0 * torch.randn((Bc, kv, R, hd), generator=g, device=dev)
    k = torch.randn((Bc, S, kv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((Bc, S, kv, hd), generator=g, device=dev).to(dtype)
    return q, k, v


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _check(q, k, v, lo, hi, partial=False, tol=CARD_TOL):
    got = ops.decode_attention(q, k, v, lo, hi, partial=partial)
    want = REF.decode_attention_ref(q, k, v, lo, hi, partial=partial)
    torch.cuda.synchronize()
    if not partial:
        assert got.shape == want.shape
        assert _rel(got, want) <= tol
        return
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if hi > lo:
            assert _rel(a, b) <= tol
        else:
            assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CELLS))
def test_card_kernel_at_the_decode_cells(card, cell):
    """B 8 against a 32768-slot bf16 cache: the cells' first and last
    steps' ranges, and a TP-style partial of the whole cache."""
    kv, R, hd = CELLS[cell]
    q, k, v = _card_operands(card, 8, 32768, kv, R, hd, torch.bfloat16)
    for hi in (32257, 32768):
        _check(q, k, v, 0, hi)
    _check(q, k, v, 0, 32768, partial=True)


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_card_kernel_ragged_edges_and_empty_range(card, dtype):
    """Ranges whose ends cut a block's pass and a split's chunk, one
    slot, forced split counts from one to many, and an empty TP range
    (0, -1e30, 0)."""
    dt = DTYPES[dtype]
    q, k, v = _card_operands(card, 3, 3000, 2, 2, 64, dt, seed=1)
    for lo, hi in ((0, 1), (5, 6), (3, 131), (7, 2999), (0, 3000),
                   (1000, 1257), (129, 2177)):
        _check(q, k, v, lo, hi)
        _check(q, k, v, lo, hi, partial=True)
    for bps in (1, 3, 64, 1000):
        plan = DA._plan(3, 2, 2, 64, 2990, k.element_size(), 132, bps)
        got = DA._launch(q, k, v, 7, 2997, False, plan)
        want = REF.decode_attention_ref(q, k, v, 7, 2997)
        assert _rel(got, want) <= CARD_TOL, plan
    o, m, l = ops.decode_attention(q, k, v, 17, 17, partial=True)
    torch.cuda.synchronize()
    assert torch.all(o == 0) and torch.all(m == -1e30) and torch.all(l == 0)
    with pytest.raises(ValueError, match="no valid slot"):
        ops.decode_attention(q, k, v, 17, 17)


def _config_widths():
    """(hd, R) of every attention config and its reduced form, and the
    padded heads of TP 16 (arctic's 56 -> 64)."""
    out = set()
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), get_config(arch).reduced()):
            if cfg.attention_free:
                continue
            out.add((cfg.hd, cfg.n_heads // cfg.n_kv_heads))
            out.add((cfg.hd, cfg.padded_heads(16) // cfg.n_kv_heads))
    return sorted(out)


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_card_kernel_every_config_width(card, dtype):
    widths = _config_widths()
    assert {(64, 1), (128, 2), (80, 1), (128, 16), (128, 7)} <= set(widths)
    for i, (hd, R) in enumerate(widths):
        q, k, v = _card_operands(card, 2, 2500, 3, R, hd, DTYPES[dtype],
                                 seed=10 + i)
        _check(q, k, v, 11, 2411)
        _check(q, k, v, 0, 2500, partial=True)


@pytest.mark.card
def test_card_kernel_reads_views_in_place(card):
    """A stacked layer's view (the decode cells' cache) and a slot stride
    wider than the heads: no copy, the same numbers."""
    g = torch.Generator(device=card).manual_seed(4)
    big = torch.randn((3, 2, 2000, 4, 128), generator=g,
                      device=card).to(torch.bfloat16)
    q = torch.randn((2, 4, 2, 128), generator=g, device=card)
    _check(q, big[1], big[2], 0, 1999)
    wide = torch.randn((2, 1500, 6, 64), generator=g, device=card)
    k, v = wide[:, :, :2], wide[:, :, 3:5]
    assert not k.is_contiguous()
    _check(torch.randn((2, 2, 4, 64), generator=g, device=card), k, v, 2,
           1499)


class _Ops(TorchDispatchMode):
    """The aten ops a call dispatches."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.card
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-1.7b"])
def test_card_decode_step_runs_the_kernel(card, arch, monkeypatch):
    """A bf16 decode step of the reduced config against a 4096-slot cache:
    ``launches`` moves by each layer's plan (one or two launches), the
    plain version is never called, and no library attention or batched
    product runs."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    cache = lm.init_cache(cfg, 2, 4096, dtype=torch.bfloat16, device=card)
    tok = torch.ones((2, 1), dtype=torch.int32, device=card)
    plain = []
    monkeypatch.setattr(REF, "decode_attention_ref",
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        lambda *a, **k: plain.append("sdpa"))
    kv, R = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    for pos in (5, 4000):
        plan = DA._plan(2, kv, R, cfg.hd, pos + 1, 2, DA._sms(card.index))
        before = DA.decode_attention.launches
        with _Ops() as seen:
            tok, cache = lm.decode_step(cfg, params, cache, tok, pos)
        torch.cuda.synchronize()
        per = 1 if plan.nsplit == 1 else 2
        assert DA.decode_attention.launches - before == cfg.n_layers * per
        assert not any("bmm" in n or "attention" in n for n in seen.names)
    assert plain == []
