"""Transformer layers of every LM family: the port of
``repro/models/layers.py``, unsharded (train, prefill and decode).

Conventions kept from the reference, so weights carry over one to one and
the tests compare like with like:

  * params are nested dicts of tensors with the reference's names and
    layouts (``wq`` is (d, Hq * hd), ``head.w`` is (d, V_padded));
  * activations are (B, S, d); q is (B, S, KVg, R, hd) out of
    ``_project_qkv``, kv head g serving q heads g * R .. g * R + R - 1;
  * every function takes an ``AxisCtx``; only the unsharded one exists
    (``common/axes.py``).

Train and prefill attention go through ``kernels.ops.flash_attention``
(the hand-written kernels on the card, their plain versions on the CPU)
where the reference scans ``chunked_attention``: the same function with
q0 = k0 = 0, causal or not, with or without a sliding window, Sq = Sk or
(cross-attention) not. Decode attends one token against the KV cache in
plain PyTorch, as the reference does with einsums: the whole cache read
in fp32 (dequantized first when it is int8). The cache is written in
place: ``decode_attention_block`` stores the new token's k and v into
its slot and returns the same tensors, where the reference returns an
updated copy. Initializers draw from a ``torch.Generator`` (the
reference's ``jax.random`` stream cannot be reproduced; the tests carry
its weights across instead).
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from repro_torch.common.axes import AxisCtx, UNSHARDED
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    """Normal(0, 1/sqrt(fan_in)) drawn in fp32 on the generator's device,
    then cast (fan_in = shape[0] for a matrix)."""
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
# embeddings
# ---------------------------------------------------------------------------


def embed_params(gen, cfg: ModelConfig, vocab_local: int):
    return {"table": _dense_init(gen, (vocab_local, cfg.d_model),
                                 _dtype(cfg.param_dtype), scale=0.02)}


def embed_lookup(cfg: ModelConfig, p, ids, ax: AxisCtx = UNSHARDED):
    """ids (B, S) of global vocab ids -> (B, S, d); ids outside the table
    embed to zeros, as in the reference."""
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
# LM head: cross entropy (stable, fp32)
# ---------------------------------------------------------------------------


def head_params(gen, cfg: ModelConfig, vocab_local: int):
    return {"w": _dense_init(gen, (cfg.d_model, vocab_local),
                             _dtype(cfg.param_dtype))}


def _masked_logits(cfg: ModelConfig, p, x, ax: AxisCtx):
    """fp32 (B, S, V_padded) logits, the vocab-padding columns at -1e30."""
    logits = (x @ p["w"]).float()
    v_loc = logits.shape[-1]
    gid = ax.tp_index() * v_loc + torch.arange(v_loc, device=logits.device)
    return torch.where(gid < cfg.vocab_size, logits, -1e30)


def lm_head_loss(cfg: ModelConfig, p, x, targets, ax: AxisCtx = UNSHARDED):
    """Mean cross-entropy. x: (B, S, d), targets: (B, S) global ids."""
    logits = _masked_logits(cfg, p, x, ax)
    m = torch.amax(logits, -1)
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
    """Greedy decode read-out: -> (argmax id, ties to the lowest, and its
    logit), each (B, S)."""
    logits = _masked_logits(cfg, p, x, ax)
    idx = torch.argmax(logits, -1)
    return idx + ax.tp_index() * logits.shape[-1], torch.amax(logits, -1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_params(gen, cfg: ModelConfig):
    """Global param shapes (unsharded: the q heads unpadded); a
    cross-attention block has the same params."""
    dt = _dtype(cfg.param_dtype)
    d, hd, hq = cfg.d_model, cfg.hd, cfg.n_heads
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
    (B, Skv, KVg, hd). Rope applies when ``rope_theta > 0`` and positions
    are given (q at ``positions``, k at ``kv_positions``)."""
    hd = cfg.hd
    q = x @ ax.all_gather_param(p["wq"], 0)
    k = x_kv @ ax.all_gather_param(p["wk"], 0)
    v = x_kv @ ax.all_gather_param(p["wv"], 0)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S, Skv = x.shape[0], x.shape[1], x_kv.shape[1]
    q = q.reshape(B, S, q.shape[-1] // hd, hd)
    k = k.reshape(B, Skv, k.shape[-1] // hd, hd)
    v = v.reshape(B, Skv, v.shape[-1] // hd, hd)
    kvg = k.shape[2]
    if cfg.qk_norm:
        q = rms_head_norm(p["qnorm"], q)
        k = rms_head_norm(p["knorm"], k)
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
    the config's; ``window > 0`` is a sliding window. Heads go to the
    kernels' (B, H, S, hd)."""
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


def decode_attention_block(cfg: ModelConfig, p, x, cache, pos: int,
                           ax: AxisCtx = UNSHARDED, *, window: int = 0,
                           inject: bool = True, kv_len=None,
                           ring_window: int = 0):
    """One-token decode against the cache. x: (B, 1, d); cache k / v
    (B, S, KV, hd) (int8 with bf16 ``k_scale`` / ``v_scale``); pos: the
    token's absolute position (a Python int).

    ``inject``: the token's k and v go into slot pos (``pos %
    ring_window`` for a ring buffer of ``ring_window`` slots), in place; a
    slot outside the cache is silently skipped, as the reference drops it.
    Keys at slots <= pos are seen (all of them once a ring has wrapped),
    within ``window`` of pos when it is > 0. ``inject=False``:
    cross-attention against a static cache whose first ``kv_len`` slots
    are valid. Returns (y (B, 1, d), cache), the cache the same tensors."""
    B, hd, KV = x.shape[0], cfg.hd, cfg.n_kv_heads
    at = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, x, ax, at, at)
    S = cache["k"].shape[1]
    quantized = cache["k"].dtype == torch.int8
    if inject:
        slot = pos % ring_window if ring_window else pos
        if 0 <= slot < S:
            if quantized:
                kq, ks = _quantize_kv(k_new)
                vq, vs = _quantize_kv(v_new)
                _cache_write(cache, ("k", "v", "k_scale", "v_scale"),
                             (kq, vq, ks, vs), slot)
            else:
                _cache_write(cache, ("k", "v"), (k_new, v_new), slot)
    if quantized:
        k_eff = _dequantize_kv(cache["k"], cache["k_scale"])
        v_eff = _dequantize_kv(cache["v"], cache["v_scale"])
    else:
        k_eff, v_eff = cache["k"].float(), cache["v"].float()

    kpos = torch.arange(S, device=x.device)
    if not inject:
        valid = kpos < (kv_len if kv_len is not None else S)
    elif ring_window:
        # a ring holds the last ``ring_window`` tokens once it has wrapped;
        # before that only slots <= pos are filled
        valid = (kpos <= pos) | (pos >= ring_window)
    else:
        valid = kpos <= pos
        if window > 0:
            valid = valid & (kpos > pos - window)
    qf = q.reshape(B, KV, -1, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bgrh,bkgh->bgrk", qf, k_eff)
    s = torch.where(valid, s, -1e30)
    m = torch.amax(s, -1, keepdim=True)
    pr = torch.exp(s - m)
    l = torch.sum(pr, -1)
    o = torch.einsum("bgrk,bkgh->bgrh", pr, v_eff)
    o = o / torch.clamp(l, min=1e-30)[..., None]
    y = o.reshape(B, 1, -1).to(x.dtype) @ ax.all_gather_param(p["wo"], 1)
    return ax.psum_tp(y), cache


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
    h = x @ ax.all_gather_param(p["wi"], 0)
    if cfg.act == "swiglu":
        h = F.silu(x @ ax.all_gather_param(p["wg"], 0)) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return ax.psum_tp(h @ ax.all_gather_param(p["wo"], 1))
