"""RWKV6 ("Finch") block: the port of ``repro/models/rwkv.py``, unsharded
or with its heads split over the "model" axis. Attention-free time mix
with a data-dependent decay, then a channel mix. [arXiv:2404.05892]

Time mix, per head of ``rwkv_head_size`` channels, with an (hd x hd)
fp32 matrix state S (the decode cache: O(1) in the sequence length):

  w_t = exp(-exp(w0 + tanh(x_w A_w) B_w))           (data-dependent decay)
  y_t = r_t (S_{t-1} + u * (k_t (x) v_t))             (u: the bonus)
  S_t = w_t * S_{t-1} + k_t (x) v_t

then a per-head group norm (population variance), a silu gate and the
output projection. The token-shift mixes run in fp32 and are cast back to
the activations' dtype before each projection. The recurrence is a plain
loop over time in fp32, as the reference's ``lax.scan`` (no TPU kernel
stands behind it). The carried token of each mix is ``x[:, -1]``.

On a mesh the r / k / v / g projections are split by head over TP, the
output projection by rows (a psum over TP closes the block); the decay
runs replicated over all of d (its LoRA is replicated) and each rank
slices its heads' block of it. The mixes entering the split projections
and the full decay are marked TP-varying where they enter. The channel
mix's k projection is split by column, its v by row (psum), its gate
``wr`` replicated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.axes import AxisCtx, UNSHARDED
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init, _dtype
from repro_torch.sharding.analysis import repeat_step

_DECAY_LORA = 64


def rwkv_time_params(gen, cfg: ModelConfig):
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    f32 = torch.float32
    return {"mu": _dense_init(gen, (5, d), f32, scale=0.2),   # r, k, v, w, g
            "w0": torch.full((d,), -6.0, dtype=f32, device=gen.device),
            "Aw": _dense_init(gen, (d, _DECAY_LORA), f32, scale=0.02),
            "Bw": _dense_init(gen, (_DECAY_LORA, d), f32, scale=0.02),
            "wr": _dense_init(gen, (d, d), dt),
            "wk": _dense_init(gen, (d, d), dt),
            "wv": _dense_init(gen, (d, d), dt),
            "wg": _dense_init(gen, (d, d), dt),
            "u": _dense_init(gen, (d,), f32, scale=0.5),
            "ln_scale": torch.ones((d,), dtype=f32, device=gen.device),
            "ln_bias": torch.zeros((d,), dtype=f32, device=gen.device),
            "wo": _dense_init(gen, (d, d), dt)}


def rwkv_channel_params(gen, cfg: ModelConfig):
    dt = _dtype(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": _dense_init(gen, (2, d), torch.float32, scale=0.2),  # k, r
            "wk": _dense_init(gen, (d, f), dt),
            "wv": _dense_init(gen, (f, d), dt),
            "wr": _dense_init(gen, (d, d), dt)}


def _token_shift(x, prev):
    """x shifted one token later along the sequence: the first slot takes
    ``prev`` (B, d), the previous step's last token, or zeros."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None], x[:, :-1]], 1)


def init_rwkv_state(cfg: ModelConfig, batch: int, nh_local: int,
                    dtype=torch.float32, device=None, *, lead=()):
    """A layer's zero state (the fp32 WKV state, the token-shift tails in
    ``dtype``), each leaf prefixed by the ``lead`` shape (a stack of
    layers)."""
    hd = cfg.rwkv_head_size
    zeros = lambda *shape, dt=dtype: torch.zeros((*lead, batch, *shape),
                                                 dtype=dt, device=device)
    return {"S": zeros(nh_local, hd, hd, dt=torch.float32),
            "x_att": zeros(cfg.d_model), "x_ffn": zeros(cfg.d_model)}


def _wkv_step(r, k, v, w, u, S, t: int = 0):
    """Step t of the WKV loop -> (y_t (B, nh, hd), S_t)."""
    kv = k[:, t, :, :, None] * v[:, t, :, None, :]
    y = torch.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv)
    return y, w[:, t, :, :, None] * S + kv


def wkv_recurrence(r, k, v, w, u, S):
    """The WKV loop over time, fp32: r, k, v, w (B, L, nh, hd), u (nh, hd),
    S (B, nh, hd, hd) -> (y (B, L, nh, hd), the last S). On meta tensors
    one step stands for all L (``sharding.analysis.repeat_step``: every
    step costs the same)."""
    if r.is_meta:
        return repeat_step(_wkv_step, r.shape[1], (r.shape, S.shape),
                           r, k, v, w, u, S)
    ys = []
    for t in range(r.shape[1]):
        y, S = _wkv_step(r, k, v, w, u, S, t)
        ys.append(y)
    return torch.stack(ys, 1), S


def rwkv_time_mix(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED,
                  state=None):
    """x: (B, L, d) -> (y (B, L, d), the last S, the last token)."""
    B, L, d = x.shape
    hd = cfg.rwkv_head_size
    prev = state["x_att"] if state is not None else None
    xx = _token_shift(x, prev)
    xf, xxf = x.float(), xx.float()
    xr, xk, xv, xw, xg = (xf + (xxf - xf) * p["mu"][i] for i in range(5))

    proj = lambda xm, name: (ax.pvary_tp(xm.to(x.dtype))
                             @ ax.all_gather_param(p[name], 0))
    r, k, v, g = (proj(xr, "wr"), proj(xk, "wk"), proj(xv, "wv"),
                  proj(xg, "wg"))
    d_loc = r.shape[-1]
    nh = d_loc // hd

    # the decay over all of d, then this rank's heads' block of it
    w = p["w0"] + torch.tanh(xw @ p["Aw"]) @ p["Bw"]
    w = torch.exp(-torch.exp(w))
    if ax.tp:
        off = ax.tp_index() * d_loc
        w = ax.pvary_tp(w)[..., off:off + d_loc]
    heads = lambda t: t.reshape(B, L, nh, hd).float()
    S0 = (state["S"] if state is not None else
          torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device))
    y, SN = wkv_recurrence(heads(r), heads(k), heads(v), heads(w),
                           p["u"].reshape(nh, hd), S0)

    mu = torch.mean(y, -1, keepdim=True)
    var = torch.var(y, -1, keepdim=True, correction=0)
    yn = (y - mu) * torch.rsqrt(var + 1e-5)
    yn = yn * p["ln_scale"].reshape(nh, hd) + p["ln_bias"].reshape(nh, hd)
    yn = yn.reshape(B, L, d_loc) * F.silu(g.float())
    out = yn.to(x.dtype) @ ax.all_gather_param(p["wo"], 1)
    return ax.psum_tp(out), SN, x[:, -1]


def rwkv_channel_mix(cfg: ModelConfig, p, x, ax: AxisCtx = UNSHARDED,
                     state=None):
    """x: (B, L, d) -> (y (B, L, d), the last token)."""
    prev = state["x_ffn"] if state is not None else None
    xx = _token_shift(x, prev)
    xf, xxf = x.float(), xx.float()
    xk = (xf + (xxf - xf) * p["mu"][0]).to(x.dtype)
    xr = (xf + (xxf - xf) * p["mu"][1]).to(x.dtype)
    k = torch.square(F.relu(ax.pvary_tp(xk)
                            @ ax.all_gather_param(p["wk"], 0)))
    kv = ax.psum_tp(k @ ax.all_gather_param(p["wv"], 1))
    r = torch.sigmoid((xr @ p["wr"]).float())
    return (r * kv.float()).to(x.dtype), x[:, -1]
