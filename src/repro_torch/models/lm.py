"""The LM of the dense family: the port of ``repro/models/lm.py``'s
``init_params``, ``_dense_layer_apply``, ``forward`` and ``loss_fn`` for
``family="dense"``, unsharded.

Parameters are nested dicts with the repeated layers stacked on a leading
L dim (``layers``: the frozen trunk, ``adaptive_layers``: the FedSTIL
adaptive block), as in the reference, so its weights carry over leaf for
leaf (``core.convert.lm_params_from_jax``). The forward walks the stack
layer by layer where the reference scans it. The moe, vlm, ssm, hybrid
and encdec families raise NotImplementedError: they are slice 6b.
"""
from __future__ import annotations

import torch

from repro_torch.common.axes import AxisCtx, UNSHARDED
from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _dense_only(cfg: ModelConfig) -> None:
    """The ported family: dense, rotary positions (whisper's sinusoidal
    ones, like the other families, come with slice 6b)."""
    if cfg.family != "dense" or cfg.n_experts or cfg.rope_theta <= 0:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (slice "
            "6b, ROADMAP Queue 1); the port runs family='dense' with rope")


def _dense_layer_init(gen, cfg: ModelConfig):
    return {"ln1": L.norm_params(cfg, cfg.d_model, gen.device),
            "attn": L.attention_params(gen, cfg),
            "ln2": L.norm_params(cfg, cfg.d_model, gen.device),
            "mlp": L.mlp_params(gen, cfg)}


def _stack_init(gen, cfg: ModelConfig, n: int):
    layers = [_dense_layer_init(gen, cfg) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Global (unsharded) parameter tree on the generator's device, drawn
    from it in a fixed order (embed, head, trunk, adaptive layers)."""
    _dense_only(cfg)
    vp = cfg.padded_vocab()
    n_ad = cfg.n_adaptive_layers
    return {"embed": L.embed_params(gen, cfg, vp),
            "final_norm": L.norm_params(cfg, cfg.d_model, gen.device),
            "head": L.head_params(gen, cfg, vp),
            "layers": _stack_init(gen, cfg, cfg.n_layers - n_ad),
            "adaptive_layers": _stack_init(gen, cfg, n_ad)}


def _dense_layer_apply(cfg: ModelConfig, lp, x, ax: AxisCtx, positions):
    h = L.apply_norm(cfg, lp["ln1"], x)
    x = x + L.attention_block(cfg, lp["attn"], h, ax, positions=positions)
    h = L.apply_norm(cfg, lp["ln2"], x)
    return x + L.mlp_block(cfg, lp["mlp"], h, ax)


def _n_stacked(stacked) -> int:
    return stacked["ln1"]["scale"].shape[0]


def _apply_stack(cfg, stacked, x, ax, positions):
    for i in range(_n_stacked(stacked)):
        lp = tree_map(lambda a: a[i], stacked)
        x = _dense_layer_apply(cfg, lp, x, ax, positions)
    return x


def forward(cfg: ModelConfig, params, batch, ax: AxisCtx = UNSHARDED):
    """Trunk + adaptive layers -> (hidden (B, S, d), moe aux = 0)."""
    _dense_only(cfg)
    x = L.embed_lookup(cfg, params["embed"], batch["tokens"], ax)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = _apply_stack(cfg, params["layers"], x, ax, positions)
    x = _apply_stack(cfg, params["adaptive_layers"], x, ax, positions)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, params, batch, ax: AxisCtx = UNSHARDED):
    """Next-token cross-entropy (+ 0.01 x the MoE aux term, 0 here) ->
    (total, (ce, aux))."""
    x, aux = forward(cfg, params, batch, ax)
    loss = L.lm_head_loss(cfg, params["head"], x, batch["labels"], ax)
    return loss + 0.01 * aux, (loss, aux)
