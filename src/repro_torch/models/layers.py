"""Transformer layers of the dense LM family: the port of the parts of
``repro/models/layers.py`` that ``family="dense"`` runs (train and
prefill), unsharded.

Conventions kept from the reference, so weights carry over one to one and
the tests compare like with like:

  * params are nested dicts of tensors with the reference's names and
    layouts (``wq`` is (d, Hq * hd), ``head.w`` is (d, V_padded));
  * activations are (B, S, d); q is (B, S, KVg, R, hd) out of
    ``_project_qkv``, kv head g serving q heads g * R .. g * R + R - 1;
  * every function takes an ``AxisCtx``; only the unsharded one exists
    (``common/axes.py``).

Attention goes through ``kernels.ops.flash_attention`` (the hand-written
kernels on the card, their plain versions on the CPU) where the reference
scans ``chunked_attention``: the same function, causal with q0 = k0 = 0.
Initializers draw from a ``torch.Generator`` (the reference's
``jax.random`` stream cannot be reproduced; the tests carry its weights
across instead).
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
    """Global param shapes (unsharded: the q heads unpadded)."""
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


def _project_qkv(cfg: ModelConfig, p, x, ax: AxisCtx, positions):
    """Self-attention projections -> q (B, S, KVg, R, hd), k and v
    (B, S, KVg, hd)."""
    hd = cfg.hd
    q = x @ ax.all_gather_param(p["wq"], 0)
    k = x @ ax.all_gather_param(p["wk"], 0)
    v = x @ ax.all_gather_param(p["wv"], 0)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[0], x.shape[1]
    q = q.reshape(B, S, q.shape[-1] // hd, hd)
    k = k.reshape(B, S, k.shape[-1] // hd, hd)
    v = v.reshape(B, S, v.shape[-1] // hd, hd)
    kvg = k.shape[2]
    if cfg.qk_norm:
        q = rms_head_norm(p["qnorm"], q)
        k = rms_head_norm(p["knorm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(B, S, kvg, q.shape[2] // kvg, hd), k, v


def attention_block(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED, *,
                    positions):
    """Full self-attention for train / prefill: (B, S, d) -> (B, S, d)
    after the output projection. Heads go to the kernels' (B, H, S, hd)."""
    q, k, v = _project_qkv(cfg, p, x, ax, positions)
    B, S, kvg, r, hd = q.shape
    out = ops.flash_attention(
        q.reshape(B, S, kvg * r, hd).transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        causal=cfg.causal)
    out = out.transpose(1, 2).reshape(B, S, kvg * r * hd)
    return ax.psum_tp(out @ ax.all_gather_param(p["wo"], 1))


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
