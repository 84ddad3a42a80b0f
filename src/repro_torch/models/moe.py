"""Mixture-of-Experts FFN: the port of ``repro/models/moe.py``, unsharded
(every expert local).

Routing in fp32: softmax over the router's logits, the top-k experts of
each token (ties to the lowest expert id, as ``lax.top_k``: a stable
descending sort), their gates renormalized to sum to 1. Dispatch is the
reference's sort-based capacity dispatch: the (token, expert) slots
sorted stably by expert, each slot's rank within its expert, and slots of
rank >= C dropped (switch-style); every expert gathers its C rows (a pad
row where it has fewer) and runs its swiglu MLP. The switch load-balance
aux loss is E * sum(mean prob * routed share).

The combine is a gather, not a scatter-add: each token adds its kept
slots' outputs, scaled by their gates, into a zero row in ascending
expert order, in the experts' dtype (bf16 at full width). That is the
order in which the reference's scatter-add (``.at[].add``) applies a
token's updates on the CPU, and it is fixed: ``index_add_`` on the card
adds atomically in an unspecified order, so a bf16 sum of top_k = 8
terms would change from run to run.

Arctic's dense residual MLP adds on top of the expert combine (the
reference fuses its partial sum into the combine's psum, which
unsharded is the same sum).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.common.axes import AxisCtx, UNSHARDED
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init, _dtype, mlp_params

CAPACITY_FACTOR = 1.25


def _dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """The dense residual MLP's config (its hidden ``dense_ff``)."""
    return dataclasses.replace(cfg, d_ff=cfg.dense_ff or cfg.d_ff)


def moe_params(gen, cfg: ModelConfig, experts_local: int):
    dt = _dtype(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    p = {"router": _dense_init(gen, (d, cfg.n_experts), torch.float32,
                               scale=0.02),
         "wi": _dense_init(gen, (experts_local, d, f), dt),
         "wg": _dense_init(gen, (experts_local, d, f), dt),
         "wo": _dense_init(gen, (experts_local, f, d), dt)}
    if cfg.dense_residual:
        p["dense"] = mlp_params(gen, _dense_cfg(cfg))
    return p


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * CAPACITY_FACTOR)
    return max(8, ((c + 127) // 128) * 128)


def top_k_lowest(x, k: int):
    """``lax.top_k`` over the last axis: the k largest values, ties to the
    lowest index -> (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED):
    """x: (B, S, d) -> (y (B, S, d), aux loss)."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    xf = x.reshape(T, d)
    dev = x.device

    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, -1)
    gate_vals, gate_idx = top_k_lowest(probs, k)                  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    me = probs.mean(0)
    # routed counts by a scatter-add of ones (exact; bincount would read
    # the ids back to the host to size its output)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, gate_idx.reshape(-1), torch.ones(T * k, device=dev)) / (T * k)
    aux = E * torch.sum(me * ce)

    # sort-based capacity dispatch; buffer slot e * C + rank, the dropped
    # ones at the sentinel e_loc * C
    C = expert_capacity(cfg, T)
    ef = gate_idx.reshape(T * k)
    wf = gate_vals.reshape(T * k)
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(ef, stable=True)
    ef_s, tok_s, wf_s = ef[order], tok[order], wf[order]
    seg_start = torch.searchsorted(ef_s, torch.arange(E, device=dev))
    rank = torch.arange(T * k, device=dev) - seg_start[ef_s]
    e_loc = p["wi"].shape[0]
    e_off = ax.tp_index() * e_loc
    local = (ef_s >= e_off) & (ef_s < e_off + e_loc) & (rank < C)
    buf_pos = torch.where(local, (ef_s - e_off) * C + rank, e_loc * C)

    idx_buf = torch.full((e_loc * C + 1,), T, dtype=torch.long, device=dev)
    idx_buf[buf_pos] = tok_s
    w_buf = torch.zeros((e_loc * C + 1,), dtype=torch.float32, device=dev)
    w_buf[buf_pos] = wf_s
    idx_buf, w_buf = idx_buf[:e_loc * C], w_buf[:e_loc * C]

    xpad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    gathered = xpad[idx_buf].reshape(e_loc, C, d)
    h = torch.bmm(gathered, ax.all_gather_param(p["wi"], 2))
    g = torch.bmm(gathered, ax.all_gather_param(p["wg"], 2))
    y = torch.bmm(F.silu(g) * h, ax.all_gather_param(p["wo"], 1))
    y = y * w_buf.reshape(e_loc, C, 1).to(y.dtype)

    # combine: each token's kept slots in ascending expert order (a
    # dropped slot reads the zero row at e_loc * C)
    slot_buf = torch.empty_like(buf_pos)
    slot_buf[order] = buf_pos
    by_expert = torch.sort(gate_idx, dim=-1, stable=True).indices
    slot_buf = torch.gather(slot_buf.reshape(T, k), 1, by_expert)
    ypad = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))], 0)
    out = y.new_zeros((T, d))
    for j in range(k):
        out = out + ypad[slot_buf[:, j]]
    out = out.reshape(B, S, d)
    if cfg.dense_residual:
        out = out + _mlp_partial(_dense_cfg(cfg), p["dense"], x, ax)
    return ax.psum_tp(out), aux


def _mlp_partial(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED):
    """``mlp_block`` without the trailing psum (the caller's combine
    carries it)."""
    h = x @ ax.all_gather_param(p["wi"], 0)
    if cfg.act == "swiglu":
        h = F.silu(x @ ax.all_gather_param(p["wg"], 0)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ ax.all_gather_param(p["wo"], 1)
