"""Mamba2-style selective SSM block (zamba2's trunk layer): the port of
``repro/models/ssm.py``, unsharded or with its channels and heads split
over the "model" axis.

The depthwise causal conv runs on x alone and keeps a (k - 1)-token tail
as decode state; B and C are one group; the recurrence over time

  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,   y_t = C_t h_t + D x_t

is a plain loop in fp32 with the (B, nh, hd, ds) state as the decode
cache, as the reference's ``lax.scan`` (no TPU kernel stands behind it).
A = -exp(A_log) and dt = softplus(dt_r + dt_bias). The output passes a
gated RMSNorm whose mean square runs over all of d_inner.

On a mesh d_inner and the heads split over TP (w_zx, w_dt by column,
w_out by row with a psum over TP, the per-channel and per-head vectors
with them). w_zx's columns are [z | x], and ``sharding.specs.shard_tree``
deals each half on its own, so a rank holds [z_r | x_r] for its channels
and the sharded block is the unsharded one (the reference's contiguous
split hands one rank z and the other x: ROADMAP Queue 3). B and C come
from the replicated ``w_bc`` and enter the rank's heads marked
TP-varying, as the block's input does; the norm's mean square sums over
TP and re-enters the rank's channels marked TP-varying.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.axes import AxisCtx, UNSHARDED
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init, _dtype


def mamba_params(gen, cfg: ModelConfig, tp: int = 1):
    """Global param shapes (``tp`` does not change them; the reference
    takes it too)."""
    dt = _dtype(cfg.param_dtype)
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    f32, dev = torch.float32, gen.device
    return {"w_zx": _dense_init(gen, (d, 2 * di), dt),       # [z, x]
            "w_bc": _dense_init(gen, (d, 2 * ds), dt),
            "w_dt": _dense_init(gen, (d, nh), dt),
            "dt_bias": torch.zeros((nh,), dtype=f32, device=dev),
            "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                              device=dev)),
            "D": torch.ones((nh,), dtype=f32, device=dev),
            "conv_w": _dense_init(gen, (cfg.ssm_conv, di), dt, scale=0.5),
            "conv_b": torch.zeros((di,), dtype=dt, device=dev),
            "norm": torch.ones((di,), dtype=f32, device=dev),
            "w_out": _dense_init(gen, (di, d), dt)}


def _causal_depthwise_conv(x, w, b, tail=None):
    """x: (B, L, ci), w: (k, ci) depthwise, tail: (B, k - 1, ci) decode
    state or None (zeros) -> (out, the new tail). The taps add in order
    0 .. k - 1, as the reference's ``sum``."""
    k, L = w.shape[0], x.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], 1)
    out = xp[:, 0:L] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + L] * w[i]
    new_tail = xp[:, -(k - 1):] if k > 1 else None
    return out + b, new_tail


def init_ssm_state(cfg: ModelConfig, batch: int, di_local: int,
                   dtype=torch.float32, device=None, *, lead=()):
    """A layer's zero state (the fp32 scan state, the conv tail in
    ``dtype``), each leaf prefixed by the ``lead`` shape (a stack of
    layers)."""
    nh = di_local // cfg.ssm_head_dim
    return {"h": torch.zeros((*lead, batch, nh, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, di_local),
                                dtype=dtype, device=device)}


def ssm_recurrence(x, b, c, decay, dt, h):
    """The selective scan over time, fp32: x (B, L, nh, hd), b and c
    (B, L, ds), decay and dt (B, L, nh), h (B, nh, hd, ds) -> (y (B, L,
    nh, hd), the last h)."""
    ys = []
    for t in range(x.shape[1]):
        upd = ((dt[:, t, :, None, None] * x[:, t, :, :, None])
               * b[:, t, None, None, :])
        h = decay[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bhps,bs->bhp", h, c[:, t]))
    return torch.stack(ys, 1), h


def mamba_block(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED, state=None):
    """x: (B, L, d) -> (y (B, L, d), new state or None); a state (its "h"
    and "conv") means decode."""
    B, L, _ = x.shape
    hd, ds = cfg.ssm_head_dim, cfg.ssm_state
    xv = ax.pvary_tp(x)
    zx = xv @ ax.all_gather_param(p["w_zx"], 0)             # [z_r | x_r]
    di_loc = zx.shape[-1] // 2
    z, xs = zx[..., :di_loc], zx[..., di_loc:]
    bc = ax.pvary_tp((x @ ax.all_gather_param(p["w_bc"], 0)).float())
    dt_r = (xv @ ax.all_gather_param(p["w_dt"], 0)).float()

    tail = state["conv"] if state is not None else None
    xs, new_tail = _causal_depthwise_conv(xs, p["conv_w"], p["conv_b"], tail)
    xs = F.silu(xs)

    nh = di_loc // hd
    xh = xs.reshape(B, L, nh, hd).float()
    dt = torch.logaddexp(dt_r + p["dt_bias"], torch.zeros((), device=x.device))
    decay = torch.exp(dt * -torch.exp(p["A_log"]))
    h0 = (state["h"] if state is not None else
          torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device))
    y, hN = ssm_recurrence(xh, bc[..., :ds], bc[..., ds:], decay, dt, h0)
    y = (y + p["D"][None, None, :, None] * xh).reshape(B, L, di_loc)

    yf = y * F.silu(z.float())
    ss = ax.psum_tp(torch.sum(torch.square(yf), -1, keepdim=True))
    ms = ax.pvary_tp(ss / (di_loc * ax.tp_size))
    yf = yf * torch.rsqrt(ms + 1e-6) * p["norm"]
    out = ax.psum_tp(yf.to(x.dtype) @ ax.all_gather_param(p["w_out"], 1))
    new_state = None if state is None else {"h": hN, "conv": new_tail}
    return out, new_state
