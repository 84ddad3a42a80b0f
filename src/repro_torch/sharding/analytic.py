"""First-principles roofline model per (arch x shape x mesh): the port of
``repro/sharding/analytic.py``, arithmetic for arithmetic (tests hold every
returned dict equal to the reference's), so the two packages' models are
one model.

Why it exists in the reference: XLA's cost_analysis on CPU counts a
``lax.scan`` body once, so HLO-parsed FLOPs / collective bytes undercount
scanned-layer programs by ~L; this model supplies trip-count-correct
terms, validated there against an unrolled lowering (within ~15%). The
port counts its own per-rank program on meta tensors
(``launch/dryrun.py``), where every layer and time step is dispatched (or
costed one step x its trip count), and records this model beside the
count.

All quantities are per-device per-step. Collectives use ring-algorithm
wire bytes. The model holds no hardware constant: ``sharding/analysis.py``
prices its terms against the NVIDIA H100 80GB HBM3, 700 W.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import LONG_CONTEXT_WINDOW, ModelConfig, ShapeConfig

BF16 = 2
F32 = 4


def _ring_ar(msg_bytes: float, g: int) -> float:
    return 2.0 * msg_bytes * (g - 1) / max(g, 1)


def _ring_ag(full_bytes: float, g: int) -> float:
    return full_bytes * (g - 1) / max(g, 1)


@dataclasses.dataclass
class Terms:
    flops: float = 0.0          # per device
    hbm: float = 0.0            # bytes per device
    coll: float = 0.0           # wire bytes per device

    def add(self, flops=0.0, hbm=0.0, coll=0.0):
        self.flops += flops
        self.hbm += hbm
        self.coll += coll


def _family_layer(cfg: ModelConfig, B_loc, S, tp, *, train_adaptive=False,
                  fused_dense_psum=True):
    """(flops, hbm, coll) for ONE trunk layer forward on one device.
    train_adaptive=True multiplies compute by 3 (fwd+bwd) and adds the
    backward TP all-reduces (Megatron: 2 fwd + 2 bwd per layer).
    fused_dense_psum=False: pre-hillclimb arctic baseline where the
    dense-residual MLP had its own third all-reduce."""
    d, hd = cfg.d_model, cfg.hd
    H = cfg.padded_heads(tp)
    KV = cfg.n_kv_heads
    tok = B_loc * S
    t = Terms()
    act = B_loc * S * d * BF16                 # one activation tensor

    if cfg.family == "ssm":                    # rwkv6
        # time-mix: 4 projections d x d + out, head-sharded; wkv scan
        t.add(flops=2 * tok * d * (5 * d) / tp)
        t.add(flops=4 * tok * (hd if cfg.rwkv_head_size else 64)
              * cfg.d_model / tp)              # wkv state update+readout
        # channel mix: d*f in + f*d out (+ gate d*d replicated)
        t.add(flops=2 * tok * d * (2 * cfg.d_ff) / tp + 2 * tok * d * d)
        n_ar = 2                               # time-mix out + channel out
    elif cfg.family == "hybrid":               # mamba2 trunk layer
        di = cfg.d_inner
        ds = cfg.ssm_state
        nh = di // cfg.ssm_head_dim
        t.add(flops=2 * tok * d * (2 * di + 2 * ds + nh) / tp)   # in-proj
        t.add(flops=5 * tok * (di // tp) * ds)                   # ssm scan
        t.add(flops=2 * tok * di * d / tp)                       # out-proj
        n_ar = 1
    else:
        # attention projections
        t.add(flops=2 * tok * d * (H * hd + 2 * KV * hd + H * hd) / tp)
        # attention quadratic (causal halves)
        causal_f = 0.5 if cfg.causal else 1.0
        t.add(flops=4 * B_loc * S * S * (H / tp) * hd * causal_f)
        if cfg.n_experts:                      # MoE FFN (top-k, expert-par)
            t.add(flops=2 * tok * cfg.top_k * (3 * d * cfg.d_ff) / tp)
            t.add(flops=2 * tok * d * cfg.n_experts)             # router
            if cfg.dense_residual:
                t.add(flops=2 * tok * (3 * d * (cfg.dense_ff or cfg.d_ff)) / tp)
        else:
            n_mats = 3 if cfg.act == "swiglu" else 2
            t.add(flops=2 * tok * d * (n_mats * cfg.d_ff) / tp)
        n_ar = 2                               # attn out + ffn out
        if cfg.dense_residual and not fused_dense_psum:
            n_ar = 3                           # pre-fusion arctic baseline

    mult = 3.0 if train_adaptive else 1.0
    t.flops *= mult
    n_ar_total = n_ar * (2 if train_adaptive else 1)
    t.add(coll=n_ar_total * _ring_ar(act, tp))
    # activation traffic: ~6 tensor read/writes per layer (fwd)
    t.add(hbm=6 * act * mult)
    return t


def _layer_param_bytes(cfg: ModelConfig, tp: int) -> float:
    """Per-device parameter bytes of ONE trunk layer."""
    d, hd = cfg.d_model, cfg.hd
    H = cfg.padded_heads(tp)
    KV = cfg.n_kv_heads
    if cfg.family == "ssm":
        n = d * 5 * d / tp + d * (2 * cfg.d_ff) / tp + d * d
    elif cfg.family == "hybrid":
        di = cfg.d_inner
        n = d * (2 * di + 2 * cfg.ssm_state + di // cfg.ssm_head_dim) / tp \
            + di * d / tp
    else:
        attn = d * (2 * H * hd) / tp + d * 2 * KV * hd / max(
            tp if KV >= tp else 1, 1)
        if cfg.n_experts:
            ffn = cfg.n_experts * 3 * d * cfg.d_ff / tp + d * cfg.n_experts
            if cfg.dense_residual:
                ffn += 3 * d * (cfg.dense_ff or cfg.d_ff) / tp
        else:
            ffn = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff / tp
        n = attn + ffn
    return n * BF16


def analytic_roofline(cfg: ModelConfig, shape: ShapeConfig, *, tp=16, dp=16,
                      pods=1, fused_dense_psum=True,
                      decode_ws=False, ws_fused=True) -> Dict[str, float]:
    d = cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    dpp = dp * pods
    B_loc = B // dpp if B % dpp == 0 else (
        B // dp if B % dp == 0 else B)             # replicate if indivisible
    Vp = cfg.padded_vocab()
    L = cfg.n_layers
    n_ad = cfg.n_adaptive_layers
    t = Terms()

    params_dev = L * _layer_param_bytes(cfg, tp) + 2 * Vp * d * BF16 / tp
    if cfg.n_enc_layers:
        params_dev += cfg.n_enc_layers * _layer_param_bytes(cfg, tp)
    if cfg.fsdp:
        params_dev /= dp

    if shape.mode in ("train", "prefill"):
        train = shape.mode == "train"
        S_eff = S - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
        # trunk layers (fwd only under the FedSTIL frozen split)
        trunk = _family_layer(cfg, B_loc, S, tp,
                              fused_dense_psum=fused_dense_psum)
        t.add(trunk.flops * (L - n_ad), trunk.hbm * (L - n_ad),
              trunk.coll * (L - n_ad))
        ad = _family_layer(cfg, B_loc, S, tp, train_adaptive=train,
                           fused_dense_psum=fused_dense_psum)
        t.add(ad.flops * n_ad, ad.hbm * n_ad, ad.coll * n_ad)
        if cfg.family == "encdec":
            enc = _family_layer(cfg, B_loc, cfg.enc_seq or 1536, tp)
            t.add(enc.flops * cfg.n_enc_layers, enc.hbm * cfg.n_enc_layers,
                  enc.coll * cfg.n_enc_layers)
            # cross attention (S x enc_seq) per decoder layer
            t.add(flops=4 * B_loc * S * 1536 * (cfg.padded_heads(tp) / tp)
                  * cfg.hd * L)
        # embedding psum + head
        act = B_loc * S_eff * d * BF16
        t.add(coll=_ring_ar(act, tp))
        if train:
            t.add(flops=3 * 2 * B_loc * S_eff * d * Vp / tp)
            t.add(coll=2 * _ring_ar(B_loc * S_eff * F32, tp))  # CE lse+tgt
            # adaptive grads auto-psum over data (+pod)
            ad_bytes = (n_ad * _layer_param_bytes(cfg, tp)
                        + Vp * d * BF16 / tp) * 2  # alpha+A, f32/2≈bf16x2
            t.add(coll=_ring_ar(ad_bytes * 2, dpp))
            # optimizer state rw (adaptive only, f32 m+v)
            t.add(hbm=ad_bytes * 2 * 3)
        else:
            t.add(flops=2 * B_loc * 1 * d * Vp / tp)           # last token
        # weights read once (+ fsdp gather traffic)
        t.add(hbm=params_dev * (2 if cfg.fsdp else 1))
        if cfg.fsdp:
            t.add(coll=_ring_ag(params_dev * dp, dp))

    else:  # decode: ONE token, cache of length S (or ring window)
        ring = shape.name == "long_500k" and cfg.family != "ssm"
        S_cache = LONG_CONTEXT_WINDOW if ring else S
        tok = B_loc
        H = cfg.padded_heads(tp)
        hd = cfg.hd
        KV = cfg.n_kv_heads

        # per layer: projections (head-sharded) + cache attention (seq/tp)
        if cfg.family == "ssm":
            t.add(flops=L * (2 * tok * d * 5 * d / tp
                             + 4 * tok * (d / tp) * cfg.rwkv_head_size
                             + 2 * tok * d * 2 * cfg.d_ff / tp))
            state_bytes = L * B_loc * (d / tp) * cfg.rwkv_head_size * F32
            t.add(hbm=2 * state_bytes)
            t.add(coll=L * 2 * _ring_ar(B_loc * d * BF16, tp))
        elif cfg.family == "hybrid":
            di = cfg.d_inner
            n_groups = L // cfg.attn_every
            t.add(flops=L * (2 * tok * d * (2 * di) / tp + 5 * tok * (di / tp)
                             * cfg.ssm_state + 2 * tok * di * d / tp))
            state_bytes = L * B_loc * (di / tp) * cfg.ssm_state * F32
            cache_bytes = (n_groups * B_loc * (S_cache / tp) * KV * hd
                           * 2 * BF16)
            t.add(hbm=2 * state_bytes + cache_bytes)
            t.add(flops=n_groups * 4 * tok * (S_cache / tp) * KV
                  * (H // KV) * hd)
            t.add(coll=L * _ring_ar(B_loc * d * BF16, tp)
                  + n_groups * 2 * _ring_ar(B_loc * H * hd * F32, tp))
        else:
            n_dec = L
            proj = 2 * tok * d * (2 * H * hd + 2 * KV * hd) / tp
            if cfg.n_experts:
                ffn = 2 * tok * cfg.top_k * 3 * d * cfg.d_ff / tp
                if cfg.dense_residual:
                    ffn += 2 * tok * 3 * d * (cfg.dense_ff or cfg.d_ff) / tp
            else:
                ffn = 2 * tok * (3 if cfg.act == "swiglu" else 2) * d \
                    * cfg.d_ff / tp
            attn_read = 4 * tok * (S_cache / tp) * KV * max(H // KV, 1) * hd
            t.add(flops=n_dec * (proj + ffn + attn_read))
            cache_bytes = n_dec * B_loc * (S_cache / tp) * KV * hd * 2 * BF16
            if cfg.family == "encdec":
                cache_bytes += n_dec * B_loc * (1536 / tp) * KV * hd * 2 * BF16
                t.add(flops=n_dec * 4 * tok * (1536 / tp) * KV
                      * max(H // KV, 1) * hd)
            t.add(hbm=cache_bytes)       # read whole cache
            # flash-decode merge (m,l,o in f32) + layer output psums
            merge = B_loc * H * hd * F32 + 2 * B_loc * H * F32
            t.add(coll=n_dec * (2 * _ring_ar(merge, tp)
                                + 2 * _ring_ar(B_loc * d * BF16, tp)))
        # head + embed
        t.add(flops=2 * tok * d * Vp / tp)
        t.add(coll=_ring_ar(B_loc * d * BF16, tp))
        # weights read once per token step
        if cfg.fsdp and decode_ws:
            # weight-stationary: weights stay sharded; activations move.
            B_tot = B_loc * dp
            act = B_tot * d * BF16
            hd_ = cfg.hd
            H_ = cfg.padded_heads(tp)
            qkv_cols = H_ * hd_ / tp + 2 * KV * hd_
            mlp_cols = (2 if cfg.act == "swiglu" else 1) * (
                cfg.top_k * cfg.d_ff / tp if cfg.n_experts else cfg.d_ff / tp)
            if ws_fused:
                # iteration 2: one x-gather + one psum per projection group
                per_layer = (2 * _ring_ag(act, dp)
                             + _ring_ar(B_tot * qkv_cols * BF16, dp)
                             + _ring_ar(B_tot * mlp_cols * BF16, dp)
                             + _ring_ar(B_loc * d / dp * BF16, tp)
                             + 2 * _ring_ag(B_loc * d * BF16, dp))
            else:
                # iteration 1: separate gather+psum per weight matrix
                per_layer = (5 * _ring_ag(act, dp)
                             + 3 * _ring_ar(B_tot * qkv_cols / 3 * BF16, dp)
                             + 2 * _ring_ar(B_tot * mlp_cols / 2 * BF16, dp)
                             + _ring_ar(B_loc * d / dp * BF16, tp)
                             + 2 * _ring_ag(B_loc * d * BF16, dp))
            t.add(hbm=params_dev)
            t.add(coll=L * per_layer)
        else:
            t.add(hbm=params_dev * (2 if cfg.fsdp else 1))
            if cfg.fsdp:
                t.add(coll=_ring_ag(params_dev * dp, dp))

    return {"flops_per_device": t.flops, "hbm_bytes_per_device": t.hbm,
            "collective_bytes_per_device": t.coll,
            "params_bytes_per_device": params_dev}
