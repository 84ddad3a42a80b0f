"""Model assembly for every LM family: the port of ``repro/models/lm.py``,
unsharded.

Parameters are nested dicts with the repeated layers stacked on a leading
L dim (``layers``: the frozen trunk, ``adaptive_layers``: the FedSTIL
adaptive block; hybrid's adaptive part is its weight-shared attention
block, ``shared_attn``), as in the reference, so its weights carry over
leaf for leaf (``core.convert.lm_params_from_jax``). The forward walks
each stack layer by layer where the reference scans it.

Families:
  dense / moe / vlm : decoder-only LM (vlm: stub vision tokens prepended)
  ssm (rwkv6)       : attention-free time-mix / channel-mix stack
  hybrid (zamba2)   : groups of ``attn_every`` mamba2 layers, each group
                      followed by one weight-shared attention block
  encdec (whisper)  : stub-frame encoder (non-causal) + causal decoder
                      with cross-attention

Decode (``decode_step``) feeds one token against the cache of
``init_cache`` (a bf16, fp32 or int8 KV cache, full or a ring of
``window`` slots; the rwkv and mamba states), which it updates in place
and returns: the reference returns an updated copy, which at a 32k cache
would copy gigabytes a step. ``pos`` is a Python int.
"""
from __future__ import annotations

import torch

from repro_torch.common.axes import AxisCtx, UNSHARDED
from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM

# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _dense_layer_init(gen, cfg: ModelConfig):
    block = {"ln1": L.norm_params(cfg, cfg.d_model, gen.device),
             "attn": L.attention_params(gen, cfg),
             "ln2": L.norm_params(cfg, cfg.d_model, gen.device)}
    if cfg.family == "moe" or (cfg.n_experts and cfg.family != "hybrid"):
        block["moe"] = MOE.moe_params(gen, cfg, cfg.n_experts)
    else:
        block["mlp"] = L.mlp_params(gen, cfg)
    return block


def _rwkv_layer_init(gen, cfg: ModelConfig):
    return {"ln1": L.norm_params(cfg, cfg.d_model, gen.device),
            "time": RWKV.rwkv_time_params(gen, cfg),
            "ln2": L.norm_params(cfg, cfg.d_model, gen.device),
            "chan": RWKV.rwkv_channel_params(gen, cfg)}


def _mamba_layer_init(gen, cfg: ModelConfig):
    return {"ln": L.norm_params(cfg, cfg.d_model, gen.device),
            "mamba": SSM.mamba_params(gen, cfg)}


def _enc_layer_init(gen, cfg: ModelConfig):
    return {"ln1": L.norm_params(cfg, cfg.d_model, gen.device),
            "attn": L.attention_params(gen, cfg),
            "ln2": L.norm_params(cfg, cfg.d_model, gen.device),
            "mlp": L.mlp_params(gen, cfg)}


def _dec_layer_init(gen, cfg: ModelConfig):
    return {"ln1": L.norm_params(cfg, cfg.d_model, gen.device),
            "attn": L.attention_params(gen, cfg),
            "lnx": L.norm_params(cfg, cfg.d_model, gen.device),
            "cross": L.attention_params(gen, cfg),
            "ln2": L.norm_params(cfg, cfg.d_model, gen.device),
            "mlp": L.mlp_params(gen, cfg)}


def _stack_init(init, gen, cfg: ModelConfig, n: int):
    layers = [init(gen, cfg) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Global (unsharded) parameter tree on the generator's device, drawn
    from it in a fixed order (embed, head, then the stacks)."""
    vp = cfg.padded_vocab()
    n_ad = cfg.n_adaptive_layers
    n_trunk = cfg.n_layers - n_ad
    params = {"embed": L.embed_params(gen, cfg, vp),
              "final_norm": L.norm_params(cfg, cfg.d_model, gen.device),
              "head": L.head_params(gen, cfg, vp)}
    if cfg.family in ("dense", "moe", "vlm"):
        params["layers"] = _stack_init(_dense_layer_init, gen, cfg, n_trunk)
        params["adaptive_layers"] = _stack_init(_dense_layer_init, gen, cfg,
                                                n_ad)
    elif cfg.family == "ssm":
        params["layers"] = _stack_init(_rwkv_layer_init, gen, cfg, n_trunk)
        params["adaptive_layers"] = _stack_init(_rwkv_layer_init, gen, cfg,
                                                n_ad)
    elif cfg.family == "hybrid":
        params["layers"] = _stack_init(_mamba_layer_init, gen, cfg,
                                       cfg.n_layers)
        params["shared_attn"] = _dense_layer_init(gen, cfg)
    elif cfg.family == "encdec":
        params["enc_layers"] = _stack_init(_enc_layer_init, gen, cfg,
                                           cfg.n_enc_layers)
        params["enc_norm"] = L.norm_params(cfg, cfg.d_model, gen.device)
        params["layers"] = _stack_init(_dec_layer_init, gen, cfg, n_trunk)
        params["adaptive_layers"] = _stack_init(_dec_layer_init, gen, cfg,
                                                n_ad)
    else:
        raise ValueError(cfg.family)
    return params


# ---------------------------------------------------------------------------
# layer application (train / prefill)
# ---------------------------------------------------------------------------


def _dense_layer_apply(cfg: ModelConfig, lp, x, ax: AxisCtx, positions,
                       window: int = 0):
    """-> (x, moe aux: 0 without experts)."""
    h = L.apply_norm(cfg, lp["ln1"], x)
    x = x + L.attention_block(cfg, lp["attn"], h, ax, positions=positions,
                              window=window)
    h = L.apply_norm(cfg, lp["ln2"], x)
    if "moe" in lp:
        y, aux = MOE.moe_block(cfg, lp["moe"], h, ax)
        return x + y, aux
    return x + L.mlp_block(cfg, lp["mlp"], h, ax), x.new_zeros((),
                                                           dtype=torch.float32)


def _rwkv_layer_apply(cfg: ModelConfig, lp, x, ax: AxisCtx, state=None):
    h = L.apply_norm(cfg, lp["ln1"], x)
    y, S_new, last_att = RWKV.rwkv_time_mix(cfg, lp["time"], h, ax, state)
    x = x + y
    h = L.apply_norm(cfg, lp["ln2"], x)
    y, last_ffn = RWKV.rwkv_channel_mix(cfg, lp["chan"], h, ax, state)
    new_state = None
    if state is not None:
        new_state = {"S": S_new, "x_att": last_att, "x_ffn": last_ffn}
    return x + y, new_state


def _mamba_layer_apply(cfg: ModelConfig, lp, x, ax: AxisCtx, state=None):
    h = L.apply_norm(cfg, lp["ln"], x)
    y, new_state = SSM.mamba_block(cfg, lp["mamba"], h, ax, state)
    return x + y, new_state


def _n_stacked(stacked) -> int:
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return first.shape[0]


def _layers(stacked):
    """The layers of a stacked tree, one tree of views each."""
    return [tree_map(lambda a: a[i], stacked)
            for i in range(_n_stacked(stacked))]


def _encode(cfg: ModelConfig, params, enc, ax: AxisCtx):
    """The encoder stack over frames with their positions added."""
    enc_pos = torch.arange(enc.shape[1], device=enc.device).expand(
        enc.shape[:2])
    for lp in _layers(params["enc_layers"]):
        h = L.apply_norm(cfg, lp["ln1"], enc)
        enc = enc + L.attention_block(cfg, lp["attn"], h, ax,
                                      positions=enc_pos, causal=False)
        h = L.apply_norm(cfg, lp["ln2"], enc)
        enc = enc + L.mlp_block(cfg, lp["mlp"], h, ax)
    return L.apply_norm(cfg, params["enc_norm"], enc), enc_pos


# ---------------------------------------------------------------------------
# forward (train / prefill): returns final hidden states + moe aux
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ModelConfig, params, batch, ax: AxisCtx):
    x = L.embed_lookup(cfg, params["embed"], batch["tokens"], ax)
    if cfg.family == "vlm":
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], 1)
    if cfg.rope_theta <= 0:           # sinusoidal positions (whisper)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                       device=x.device).to(x.dtype)
    return x


def forward(cfg: ModelConfig, params, batch, ax: AxisCtx = UNSHARDED, *,
            window: int = 0):
    """Trunk + adaptive layers -> (hidden (B, S, d), moe aux). ``batch``
    holds ``tokens``, and ``vision_embeds`` (vlm) or ``frames`` (encdec);
    ``window > 0``: sliding-window self-attention."""
    x = _embed_inputs(cfg, params, batch, ax)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux_total = x.new_zeros((), dtype=torch.float32)

    if cfg.family in ("dense", "moe", "vlm"):
        for stack in ("layers", "adaptive_layers"):
            auxs = []
            for lp in _layers(params[stack]):
                x, aux = _dense_layer_apply(cfg, lp, x, ax, positions,
                                            window)
                auxs.append(aux)
            aux_total = aux_total + torch.stack(auxs).sum()

    elif cfg.family == "ssm":
        for stack in ("layers", "adaptive_layers"):
            for lp in _layers(params[stack]):
                x, _ = _rwkv_layer_apply(cfg, lp, x, ax)

    elif cfg.family == "hybrid":
        layers = _layers(params["layers"])
        auxs = []
        for g in range(cfg.n_layers // cfg.attn_every):
            for lp in layers[g * cfg.attn_every:(g + 1) * cfg.attn_every]:
                x, _ = _mamba_layer_apply(cfg, lp, x, ax)
            x, aux = _dense_layer_apply(cfg, params["shared_attn"], x, ax,
                                        positions)
            auxs.append(aux)
        aux_total = aux_total + torch.stack(auxs).sum()

    elif cfg.family == "encdec":
        frames = batch["frames"]
        enc = frames.to(x.dtype) + L.sinusoidal_positions(
            frames.shape[1], cfg.d_model, device=x.device).to(x.dtype)
        enc, enc_pos = _encode(cfg, params, enc, ax)
        for stack in ("layers", "adaptive_layers"):
            for lp in _layers(params[stack]):
                h = L.apply_norm(cfg, lp["ln1"], x)
                x = x + L.attention_block(cfg, lp["attn"], h, ax,
                                          positions=positions, window=window)
                h = L.apply_norm(cfg, lp["lnx"], x)
                x = x + L.attention_block(cfg, lp["cross"], h, ax,
                                          positions=positions, x_kv=enc,
                                          kv_positions=enc_pos, causal=False)
                h = L.apply_norm(cfg, lp["ln2"], x)
                x = x + L.mlp_block(cfg, lp["mlp"], h, ax)
    else:
        raise ValueError(cfg.family)

    return L.apply_norm(cfg, params["final_norm"], x), aux_total


def loss_fn(cfg: ModelConfig, params, batch, ax: AxisCtx = UNSHARDED, *,
            window: int = 0, aux_weight: float = 0.01):
    """Next-token cross-entropy + aux_weight x the MoE load-balance aux ->
    (total, (ce, aux)); vlm's vision positions carry no labels."""
    x, aux = forward(cfg, params, batch, ax, window=window)
    if cfg.family == "vlm":
        x = x[:, cfg.n_vision_tokens:]
    loss = L.lm_head_loss(cfg, params["head"], x, batch["labels"], ax)
    return loss + aux_weight * aux, (loss, aux)


# ---------------------------------------------------------------------------
# decode (one token against the cache / state, updated in place)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq: int, *, enc_seq: int = 0,
               dtype=torch.bfloat16, device=None):
    """The decode cache tree of zeros: KV caches of ``seq`` slots in
    ``dtype`` for attention (int8: codes with bf16 scales, in the dense,
    moe and vlm families), the fp32 recurrent states (and ``dtype`` token
    / conv tails) for rwkv and mamba; encdec also holds cross caches of
    ``enc_seq`` slots."""
    n_ad = cfg.n_adaptive_layers
    n_trunk = cfg.n_layers - n_ad
    kv = lambda n, slots=seq: L.init_kv_cache(cfg, batch, slots, dtype,
                                              device, lead=(n,))
    # the reference keeps no int8 scales in hybrid's and encdec's caches
    # (an int8 cache of theirs cannot decode there either)
    bare = lambda n, slots=seq: {k: v for k, v in kv(n, slots).items()
                                 if k in ("k", "v")}
    if cfg.family in ("dense", "moe", "vlm"):
        return {"trunk": kv(n_trunk), "adaptive": kv(n_ad)}
    if cfg.family == "ssm":
        nh = cfg.d_model // cfg.rwkv_head_size
        mk = lambda n: RWKV.init_rwkv_state(cfg, batch, nh, dtype, device,
                                            lead=(n,))
        return {"trunk": mk(n_trunk), "adaptive": mk(n_ad)}
    if cfg.family == "hybrid":
        return {"mamba": SSM.init_ssm_state(cfg, batch, cfg.d_inner, dtype,
                                            device, lead=(cfg.n_layers,)),
                "attn": bare(cfg.n_layers // cfg.attn_every)}
    if cfg.family == "encdec":
        return {"trunk": bare(n_trunk), "adaptive": bare(n_ad),
                "cross_trunk": bare(n_trunk, enc_seq),
                "cross_adaptive": bare(n_ad, enc_seq)}
    raise ValueError(cfg.family)


def prefill_cross_cache(cfg: ModelConfig, params, frames, cache,
                        ax: AxisCtx = UNSHARDED):
    """Whisper serving: run the encoder once over frames (B, enc_seq, d)
    and fill every decoder layer's cross k / v cache (zero past enc_seq),
    in place -> (cache, encoder output)."""
    enc = frames + L.sinusoidal_positions(
        frames.shape[1], cfg.d_model, device=frames.device).to(frames.dtype)
    enc, _ = _encode(cfg, params, enc, ax)
    n = enc.shape[1]
    for stack, cross in (("layers", "cross_trunk"),
                         ("adaptive_layers", "cross_adaptive")):
        for i, lp in enumerate(_layers(params[stack])):
            _, k, v = L._project_qkv(cfg, lp["cross"], enc, enc, ax,
                                     positions=None, kv_positions=None)
            for name, val in (("k", k), ("v", v)):
                c = cache[cross][name][i]
                c[:, :n] = val.to(c.dtype)
                c[:, n:] = 0
    return cache, enc


def _layer_cache(cache, i):
    return {k: v[i] for k, v in cache.items()}


def _store_state(cache, i, new) -> None:
    for k, v in new.items():
        cache[k][i].copy_(v)


def decode_step(cfg: ModelConfig, params, cache, token, pos: int,
                ax: AxisCtx = UNSHARDED, *, window: int = 0,
                ring: bool = False, enc_len=None):
    """One greedy decode step. token: (B, 1) ids, pos: its absolute
    position (a Python int). ``window > 0``: a sliding window over the
    cache, or with ``ring=True`` a cache that is a ring buffer of
    ``window`` slots (long_500k). ``enc_len``: the encdec cross caches'
    valid length. Returns (next token (B, 1) int32, cache), the cache
    updated in place."""
    x = L.embed_lookup(cfg, params["embed"], token, ax)
    if cfg.rope_theta <= 0:
        x = x + L.sinusoidal_positions(1, cfg.d_model, offset=pos,
                                       device=x.device).to(x.dtype)
    self_kw = dict(window=0 if ring else window,
                   ring_window=window if ring else 0)

    def attn_dec(lp, xx, kv):
        h = L.apply_norm(cfg, lp["ln1"], xx)
        y, _ = L.decode_attention_block(cfg, lp["attn"], h, kv, pos, ax,
                                        **self_kw)
        return xx + y

    if cfg.family in ("dense", "moe", "vlm"):
        for stack, part in (("layers", "trunk"),
                            ("adaptive_layers", "adaptive")):
            for i, lp in enumerate(_layers(params[stack])):
                x = attn_dec(lp, x, _layer_cache(cache[part], i))
                h = L.apply_norm(cfg, lp["ln2"], x)
                if "moe" in lp:
                    y, _ = MOE.moe_block(cfg, lp["moe"], h, ax)
                else:
                    y = L.mlp_block(cfg, lp["mlp"], h, ax)
                x = x + y

    elif cfg.family == "ssm":
        for stack, part in (("layers", "trunk"),
                            ("adaptive_layers", "adaptive")):
            for i, lp in enumerate(_layers(params[stack])):
                x, new = _rwkv_layer_apply(cfg, lp, x, ax,
                                           _layer_cache(cache[part], i))
                _store_state(cache[part], i, new)

    elif cfg.family == "hybrid":
        layers = _layers(params["layers"])
        shared = params["shared_attn"]
        for g in range(cfg.n_layers // cfg.attn_every):
            for i in range(g * cfg.attn_every, (g + 1) * cfg.attn_every):
                x, new = _mamba_layer_apply(cfg, layers[i], x, ax,
                                            _layer_cache(cache["mamba"], i))
                _store_state(cache["mamba"], i, new)
            x = attn_dec(shared, x, _layer_cache(cache["attn"], g))
            h = L.apply_norm(cfg, shared["ln2"], x)
            x = x + L.mlp_block(cfg, shared["mlp"], h, ax)

    elif cfg.family == "encdec":
        for stack, part, cross in (("layers", "trunk", "cross_trunk"),
                                   ("adaptive_layers", "adaptive",
                                    "cross_adaptive")):
            for i, lp in enumerate(_layers(params[stack])):
                x = attn_dec(lp, x, _layer_cache(cache[part], i))
                h = L.apply_norm(cfg, lp["lnx"], x)
                y, _ = L.decode_attention_block(
                    cfg, lp["cross"], h, _layer_cache(cache[cross], i), pos,
                    ax, inject=False, kv_len=enc_len)
                x = x + y
                h = L.apply_norm(cfg, lp["ln2"], x)
                x = x + L.mlp_block(cfg, lp["mlp"], h, ax)
    else:
        raise ValueError(cfg.family)

    x = L.apply_norm(cfg, params["final_norm"], x)
    next_tok, _ = L.lm_head_logits(cfg, params["head"], x, ax)
    return next_tok.to(torch.int32), cache
