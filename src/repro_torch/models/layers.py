"""Transformer layers of every LM family: the port of
``repro/models/layers.py`` (train, prefill and decode), unsharded or on a
mesh (Megatron tensor parallel over "model", FSDP over "data").

Conventions kept from the reference, so weights carry over one to one and
the tests compare like with like:

  * params are nested dicts of tensors with the reference's names and
    layouts (``wq`` is (d, Hq * hd), ``head.w`` is (d, V_padded)); on a
    mesh each rank holds its local shards (``sharding.specs``), head,
    ff and vocab dims divided by TP;
  * activations are (B, S, d), the same on every TP rank; q is (B, S,
    KVg, R, hd) out of ``_project_qkv`` (the rank's local GQA layout),
    kv head g serving q heads g * R .. g * R + R - 1;
  * every function takes an ``AxisCtx`` (``common/axes.py``); its
    collectives are identities when unsharded, so one code path serves
    both. A TP region starts where its input is marked varying
    (``pvary_tp``: its gradient is summed over the TP ranks) and ends in
    ``psum_tp``; each replicated value a region consumes directly (q / k
    norms on local heads, kv heads before their group slice) is marked
    where it enters.

Train and prefill attention go through ``kernels.ops.flash_attention``
(the hand-written kernels on the card, their plain versions on the CPU)
on the rank's local heads, where the reference scans
``chunked_attention``: the same function with q0 = k0 = 0, causal or
not, with or without a sliding window, Sq = Sk or (cross-attention) not.
Decode attends one token against the KV cache through
``kernels.ops.decode_attention``, where the reference computes einsums
over the whole cache in fp32: the valid slots only, one range a rank, read
in place in the cache's dtype (an int8 cache dequantized to fp32 first).
On a mesh the cache's sequence dim is split over TP: every rank attends
its chunk for all heads and the partial softmax statistics merge across
ranks (flash-decoding). The cache is written in
place: ``decode_attention_block`` stores the new token's k and v into its
slot (on the rank that owns it) and returns the same tensors, where the
reference returns an updated copy. Initializers draw from a
``torch.Generator`` (the reference's ``jax.random`` stream cannot be
reproduced; the tests carry its weights across instead), or build meta
tensors (shapes and dtypes alone) from ``SHAPES_ONLY``.
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from repro_torch.common.axes import AxisCtx, UNSHARDED
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class _ShapesOnly:
    """Stands in for a ``torch.Generator`` where only shapes and dtypes
    are wanted: every initializer then builds meta tensors."""

    device = torch.device("meta")


SHAPES_ONLY = _ShapesOnly()


def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    """Normal(0, 1/sqrt(fan_in)) drawn in fp32 on the generator's device,
    then cast (fan_in = shape[0] for a matrix)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_params(cfg: ModelConfig, d: int, device):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p, x):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.var(xf, -1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        ms = torch.mean(torch.square(xf), -1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return out.to(x.dtype)


def rms_head_norm(scale, x):
    """qk-norm: RMS over the head_dim of (B, S, H, hd)."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), -1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd), positions: (..., S) integer."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.split(x.float(), hd // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings (vocab-split over TP)
# ---------------------------------------------------------------------------


def embed_params(gen, cfg: ModelConfig, vocab_local: int):
    return {"table": _dense_init(gen, (vocab_local, cfg.d_model),
                                 _dtype(cfg.param_dtype), scale=0.02)}


def embed_lookup(cfg: ModelConfig, p, ids, ax: AxisCtx = UNSHARDED):
    """ids (B, S) of global vocab ids -> (B, S, d); ids outside the table
    (on a mesh: outside this rank's rows, summed over TP) embed to zeros,
    as in the reference."""
    table = p["table"]
    v_loc = table.shape[0]
    local = ids.long() - ax.tp_index() * v_loc
    valid = (local >= 0) & (local < v_loc)
    emb = table[torch.clamp(local, 0, v_loc - 1)]
    return ax.psum_tp(torch.where(valid[..., None], emb,
                                  torch.zeros((), dtype=emb.dtype,
                                              device=emb.device)))


def sinusoidal_positions(seq: int, d: int, offset=0, device=None):
    """(seq, d) fp32 sin | cos position codes of positions offset ..
    offset + seq - 1 (whisper's decoder and encoder)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    ang = pos[:, None] * div[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------------------------------------------------------------------
# LM head: vocab-split cross entropy (stable, fp32)
# ---------------------------------------------------------------------------


def head_params(gen, cfg: ModelConfig, vocab_local: int):
    return {"w": _dense_init(gen, (cfg.d_model, vocab_local),
                             _dtype(cfg.param_dtype))}


def _masked_logits(cfg: ModelConfig, p, x, ax: AxisCtx):
    """fp32 (B, S, V_local) logits of this rank's vocab columns, the
    vocab-padding columns at -1e30."""
    logits = (ax.pvary_tp(x) @ p["w"]).float()
    v_loc = logits.shape[-1]
    gid = ax.tp_index() * v_loc + torch.arange(v_loc, device=logits.device)
    return torch.where(gid < cfg.vocab_size, logits, -1e30)


def lm_head_loss(cfg: ModelConfig, p, x, targets, ax: AxisCtx = UNSHARDED):
    """Mean cross-entropy with the vocab dim split over TP. x: (B, S, d),
    targets: (B, S) global ids. The softmax's max-shift is the largest
    logit over every rank, gradient-free."""
    logits = _masked_logits(cfg, p, x, ax)
    m = ax.pmax_tp(torch.amax(logits, -1))
    se = torch.sum(torch.exp(logits - m[..., None]), -1)
    lse = torch.log(ax.psum_tp(se)) + m
    v_loc = logits.shape[-1]
    local_t = targets.long() - ax.tp_index() * v_loc
    valid = (local_t >= 0) & (local_t < v_loc)
    local_t = torch.clamp(local_t, 0, v_loc - 1)
    tgt = torch.gather(logits, -1, local_t[..., None])[..., 0]
    tgt = ax.psum_tp(torch.where(valid, tgt, 0.0))
    return torch.mean(lse - tgt)


def lm_head_logits(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED):
    """Greedy decode read-out: -> (argmax global id, and its logit), each
    (B, S). Ties go to the lowest global id, on one rank or across
    ranks, so a mesh reads out what one device does."""
    logits = _masked_logits(cfg, p, x, ax)
    val = torch.amax(logits, -1)
    gid = torch.argmax(logits, -1) + ax.tp_index() * logits.shape[-1]
    if not ax.tp:
        return gid, val
    best = ax.pmax_tp(val)
    mine = torch.where(val >= best, gid, torch.iinfo(gid.dtype).max)
    return ax.pmin_tp(mine), best


# ---------------------------------------------------------------------------
# weight-stationary decode matmuls (FSDP archs: the weights stay split
# over data, the activations move: gather x over data, contract the local
# slice of the contraction dim, sum over data)
# ---------------------------------------------------------------------------


def ws_colshard_matmul(x, ws, ax: AxisCtx):
    """x: (B_loc, 1, d); ws: weights (d / dp, cols_i), their contraction
    dim split over data -> [(B_loc, 1, cols_i)], one for each. One gather
    of x and one sum over data serve them all: the products of the local
    slices are joined (a few rows wide), never the weights."""
    xg = ax.all_gather_dp(x, 0)                           # (B_tot, 1, d)
    k_loc, idx, B_loc = ws[0].shape[0], ax.dp_index(), x.shape[0]
    xs = xg[..., idx * k_loc:(idx + 1) * k_loc]
    full = ax.psum_data(torch.cat([xs @ w for w in ws], -1))
    out = full[idx * B_loc:(idx + 1) * B_loc]
    return out.split([w.shape[1] for w in ws], -1)


def ws_rowshard_matmul(o, w, ax: AxisCtx):
    """o: (B_loc, 1, K_loc), K split over TP; w: (K_loc, d / dp), its
    output dim split over data -> (B_loc, 1, d). Every rank computes its
    output columns for the rows of all the data ranks (o gathered over
    data), sums them over TP, gathers the columns over data and keeps its
    own rows. (The reference gathers the columns of each rank's own rows,
    which joins different rows' columns when the batch is split over
    data: ROADMAP Queue 3.)"""
    B_loc, idx = o.shape[0], ax.dp_index()
    part = ax.psum_tp(ax.all_gather_dp(o, 0) @ w)        # (B_tot, 1, d/dp)
    return ax.all_gather_dp(part, 2)[idx * B_loc:(idx + 1) * B_loc]


def _use_ws(ax: AxisCtx) -> bool:
    return bool(ax.decode_ws and ax.fsdp and ax.dp)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_params(gen, cfg: ModelConfig, tp: int = 1):
    """Global param shapes (a cross-attention block has the same params):
    q heads padded to a multiple of ``tp`` (arctic 56 -> 64 at 16); the kv
    weights are split over TP with their heads when n_kv >= TP, else
    replicated, each rank slicing its group's head."""
    dt = _dtype(cfg.param_dtype)
    d, hd, hq = cfg.d_model, cfg.hd, cfg.padded_heads(tp)
    dev = gen.device
    p = {"wq": _dense_init(gen, (d, hq * hd), dt),
         "wk": _dense_init(gen, (d, cfg.n_kv_heads * hd), dt),
         "wv": _dense_init(gen, (d, cfg.n_kv_heads * hd), dt),
         "wo": _dense_init(gen, (hq * hd, d), dt)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["qnorm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["knorm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def _project_qkv(cfg: ModelConfig, p, x, x_kv, ax: AxisCtx, positions,
                 kv_positions):
    """q from x, k and v from x_kv -> q (B, S, KVg, R, hd), k and v
    (B, Skv, KVg, hd) in the rank's local GQA layout (KVg local kv heads,
    R local q heads each). Rope applies when ``rope_theta > 0`` and
    positions are given (q at ``positions``, k at ``kv_positions``)."""
    hd = cfg.hd
    kv_split = cfg.n_kv_heads >= ax.tp_size
    if _use_ws(ax):
        q, k, v = ws_colshard_matmul(x, [p["wq"], p["wk"], p["wv"]], ax)
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    else:
        xq = ax.pvary_tp(x)
        xk = ((xq if x_kv is x else ax.pvary_tp(x_kv)) if kv_split
              else x_kv)
        q = xq @ ax.all_gather_param(p["wq"], 0)
        k = xk @ ax.all_gather_param(p["wk"], 0)
        v = xk @ ax.all_gather_param(p["wv"], 0)
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S, Skv = x.shape[0], x.shape[1], x_kv.shape[1]
    q = q.reshape(B, S, q.shape[-1] // hd, hd)
    k = k.reshape(B, Skv, k.shape[-1] // hd, hd)
    v = v.reshape(B, Skv, v.shape[-1] // hd, hd)
    if ax.tp and not kv_split:
        # kv replicated (n_kv < TP): this rank's group takes its one head
        g = ax.tp_index() // (ax.tp_size // cfg.n_kv_heads)
        k = ax.pvary_tp(k)[:, :, g:g + 1]
        v = ax.pvary_tp(v)[:, :, g:g + 1]
    kvg = k.shape[2]
    if cfg.qk_norm:
        q = rms_head_norm(ax.pvary_tp(p["qnorm"]), q)
        k = rms_head_norm(ax.pvary_tp(p["knorm"]), k)
    if cfg.rope_theta > 0 and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q.reshape(B, S, kvg, q.shape[2] // kvg, hd), k, v


def attention_block(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED, *,
                    positions, x_kv=None, kv_positions=None, causal=None,
                    window: int = 0):
    """Full attention for train / prefill: (B, S, d) -> (B, S, d) after
    the output projection. Self-attention by default; cross-attention
    over ``x_kv`` (B, Skv, d) at ``kv_positions``. ``causal`` defaults to
    the config's; ``window > 0`` is a sliding window. The rank's local
    heads go to the kernels' (B, H, S, hd); the output projection sums
    over TP."""
    causal = cfg.causal if causal is None else causal
    x_kv = x if x_kv is None else x_kv
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(cfg, p, x, x_kv, ax, positions, kv_positions)
    B, S, kvg, r, hd = q.shape
    out = ops.flash_attention(
        q.reshape(B, S, kvg * r, hd).transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        causal=causal, window=window)
    out = out.transpose(1, 2).reshape(B, S, kvg * r * hd)
    return ax.psum_tp(out @ ax.all_gather_param(p["wo"], 1))


# -- decode: the KV cache ----------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
                  device=None, lead=()):
    """(*lead, B, S, KV, hd) k and v caches of zeros (``lead``: stacked
    layers); ``dtype=torch.int8`` is the quantized cache with (*lead, B,
    S, KV) bf16 scales beside the codes."""
    shape = tuple(lead) + (batch, seq, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                      device=device)
    return cache


def _quantize_kv(x):
    """(B, 1, KV, hd) -> (int8 codes, (B, 1, KV) bf16 scales): the scale
    max(|x|, 1e-6) / 127 in fp32 (a true division, as the reference's
    eager decode computes it), the codes x / scale rounded half to even
    with that fp32 scale, then the scale stored in bf16."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf), -1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q, scale):
    return q.float() * scale.float()[..., None]


def _cache_write(cache, names, values, slot: int) -> None:
    """Store one token's entries (each (B, 1, ...)) into slot ``slot`` of
    the caches ``names``, in place."""
    for name, value in zip(names, values):
        cache[name][:, slot] = value[:, 0].to(cache[name].dtype)


def decode_slot_range(S: int, tp_idx: int, tp_size: int, pos: int, *,
                      window: int = 0, inject: bool = True, kv_len=None,
                      ring_window: int = 0):
    """The cache slots a decode token sees on this rank, [lo, hi) local to
    its S slots (rank t holds global slots t * S ..): with ``inject``,
    slots <= pos (a ring of ``ring_window`` slots: all of them once pos
    has wrapped), within ``window`` of pos when it is > 0; without, the
    first ``kv_len`` slots (every slot when None). Each of these masks is
    one contiguous range of global slots, so one range a rank."""
    if not inject:
        lo, hi = 0, S * tp_size if kv_len is None else kv_len
    elif ring_window and pos >= ring_window:
        lo, hi = 0, S * tp_size
    else:
        lo = max(0, pos - window + 1) if window > 0 and not ring_window else 0
        hi = pos + 1
    first = tp_idx * S
    return (min(max(lo - first, 0), S), min(max(hi - first, 0), S))


def decode_attention(cfg: ModelConfig, p, x, cache, pos: int,
                     ax: AxisCtx = UNSHARDED, *, window: int = 0,
                     inject: bool = True, kv_len=None,
                     ring_window: int = 0):
    """One-token decode against the cache, up to the output projection.
    x: (B, 1, d); cache k / v (B, S_loc, KV, hd) (int8 with bf16
    ``k_scale`` / ``v_scale``), its sequence dim split over TP (rank t
    holds slots t * S_loc ..); pos: the token's absolute position (a
    Python int).

    Every rank attends its chunk for all heads: q (and the new k, v) are
    gathered over TP, a few KB a token; the partial softmax statistics
    merge across ranks (flash-decoding). ``inject``: the token's k and v
    go into slot pos (``pos % ring_window`` for a ring buffer of
    ``ring_window`` slots), in place, on the rank that owns the slot; a
    slot outside the cache is silently skipped, as the reference drops
    it. Keys at slots <= pos are seen (all of them once a ring has
    wrapped), within ``window`` of pos when it is > 0. ``inject=False``:
    cross-attention against a static cache whose first ``kv_len`` slots
    are valid. The seen slots are one range a rank
    (``decode_slot_range``), which ``ops.decode_attention`` reads in place
    (the hand-written kernel on the card). Returns every head's fp32
    output (B, 1, H, hd); the cache is updated in place. Its parts are the
    spans ``decode.qkv`` (the projection, rope, the cache write),
    ``decode.kv_read`` (an int8 cache dequantized to fp32; a bf16 or fp32
    cache has no separate read) and ``decode.attend`` (the attention and
    the merge across ranks), which tile with the caller's."""
    B, hd, KV = x.shape[0], cfg.hd, cfg.n_kv_heads
    S = cache["k"].shape[1]
    tp_idx = ax.tp_index()
    quantized = cache["k"].dtype == torch.int8
    with obs.span("decode.qkv", cat="phase", tile=True):
        at = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q, k_new, v_new = _project_qkv(cfg, p, x, x, ax, at, at)
        if ax.tp:
            # one gather for q, k and v: (B, KVg, (R + 2) hd) by local kv
            # head
            kvg, r = q.shape[2], q.shape[3]
            parts = [q.reshape(B, kvg, r * hd)]
            if inject:
                parts += [k_new.reshape(B, kvg, hd),
                          v_new.reshape(B, kvg, hd)]
            g = ax.all_gather_tp(torch.cat(parts, -1), 1)
            q = g[..., :r * hd].reshape(B, 1, -1, r, hd)
            if inject:
                k_new = g[..., r * hd:(r + 1) * hd].reshape(B, 1, -1, hd)
                v_new = g[..., (r + 1) * hd:].reshape(B, 1, -1, hd)
                if KV < ax.tp_size:
                    # each group computed the same kv head: one copy a head
                    group = ax.tp_size // KV
                    k_new, v_new = k_new[:, :, ::group], v_new[:, :, ::group]
        if inject:
            slot = (pos % ring_window if ring_window else pos) - tp_idx * S
            if 0 <= slot < S:
                if quantized:
                    kq, ks = _quantize_kv(k_new)
                    vq, vs = _quantize_kv(v_new)
                    _cache_write(cache, ("k", "v", "k_scale", "v_scale"),
                                 (kq, vq, ks, vs), slot)
                else:
                    _cache_write(cache, ("k", "v"), (k_new, v_new), slot)
    Hp = q.shape[2] * q.shape[3]
    lo, hi = decode_slot_range(S, tp_idx, ax.tp_size, pos, window=window,
                               inject=inject, kv_len=kv_len,
                               ring_window=ring_window)
    k_eff, v_eff = cache["k"], cache["v"]
    if quantized:
        with obs.span("decode.kv_read", cat="phase", tile=True):
            k_eff = _dequantize_kv(cache["k"], cache["k_scale"])
            v_eff = _dequantize_kv(cache["v"], cache["v_scale"])

    with obs.span("decode.attend", cat="phase", tile=True):
        qf = q.reshape(B, KV, Hp // KV, hd).float()
        if not ax.tp:
            o = ops.decode_attention(qf, k_eff, v_eff, lo, hi)
            return o.reshape(B, 1, Hp, hd)
        o, m, l = ops.decode_attention(qf, k_eff, v_eff, lo, hi,
                                       partial=True)
        # the flash-decoding merge: one sum over TP for o and l together
        corr = torch.exp(m - ax.pmax_tp(m))
        ol = ax.psum_tp(torch.cat([o * corr[..., None],
                                   (l * corr)[..., None]], -1))
        o, l = ol[..., :hd], ol[..., hd]
        return (o / torch.clamp(l, min=1e-30)[..., None]).reshape(B, 1, Hp,
                                                                   hd)


def decode_out_proj(cfg: ModelConfig, p, o, dtype, ax: AxisCtx = UNSHARDED):
    """The output projection of ``decode_attention``'s heads o (B, 1, H,
    hd), on this rank's slice of them, in ``dtype`` -> (B, 1, d)."""
    B, hd = o.shape[0], cfg.hd
    wo = p["wo"] if _use_ws(ax) else ax.all_gather_param(p["wo"], 1)
    h_loc = wo.shape[0] // hd
    tp_idx = ax.tp_index()
    o = o[:, :, tp_idx * h_loc:(tp_idx + 1) * h_loc].reshape(B, 1, -1)
    if _use_ws(ax):
        return ws_rowshard_matmul(o.to(dtype), wo, ax)
    return ax.psum_tp(o.to(dtype) @ wo)


def decode_attention_block(cfg: ModelConfig, p, x, cache, pos: int,
                           ax: AxisCtx = UNSHARDED, *, window: int = 0,
                           inject: bool = True, kv_len=None,
                           ring_window: int = 0):
    """``decode_attention`` then its output projection, which returns to
    the rank's heads: -> (y (B, 1, d), cache), the cache the same tensors
    updated in place."""
    o = decode_attention(cfg, p, x, cache, pos, ax, window=window,
                         inject=inject, kv_len=kv_len,
                         ring_window=ring_window)
    return decode_out_proj(cfg, p, o, x.dtype, ax), cache


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------


def mlp_params(gen, cfg: ModelConfig):
    dt = _dtype(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": _dense_init(gen, (d, f), dt)}
    if cfg.act == "swiglu":
        p["wg"] = _dense_init(gen, (d, f), dt)
    p["wo"] = _dense_init(gen, (f, d), dt)
    return p


def mlp_block(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED):
    if _use_ws(ax):
        if cfg.act == "swiglu":
            h, g = ws_colshard_matmul(x, [p["wi"], p["wg"]], ax)
            h = F.silu(g) * h
        else:
            h = F.gelu(ws_colshard_matmul(x, [p["wi"]], ax)[0],
                       approximate="tanh")
        return ws_rowshard_matmul(h, p["wo"], ax)
    xv = ax.pvary_tp(x)
    h = xv @ ax.all_gather_param(p["wi"], 0)
    if cfg.act == "swiglu":
        h = F.silu(xv @ ax.all_gather_param(p["wg"], 0)) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return ax.psum_tp(h @ ax.all_gather_param(p["wo"], 1))
