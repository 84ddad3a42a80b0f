"""Step builders of the LM on a mesh: the port of ``repro/launch/steps.py``.

Explicit SPMD over ``torch.distributed``: every rank runs the same Python
on its local shards. A builder returns

  * a ``LocalStep``: a function of this rank's shards of the inputs (the
    body of the reference's ``shard_map``), which emits its collectives
    through the ``AxisCtx`` it holds, with ``out_specs``, the layouts of
    its outputs;
  * the global inputs as meta tensors (shapes and dtypes, never
    allocated: the reference's ``ShapeDtypeStruct`` stand-ins);
  * the spec trees of those inputs.

A caller cuts real global inputs to its shards with
``sharding.specs.shard_tree(tree, spec, mesh)``, calls the step, and puts
outputs back together with ``gather_tree(out, step.out_specs[i], mesh)``:

    mesh = make_debug_mesh(tp=2, dp=2)          # in a world of 4 ranks
    step, args, specs = build_train_step(cfg, mesh, shape, multi_pod=False)
    local = [shard_tree(a, s, mesh) for a, s in zip(real_args, specs)]
    trainable, opt_state, metrics = step(*local)

``build_train_step`` takes two layouts: "tp" (Megatron TP over "model",
FSDP over "data" for the configs that ask for it) and "dp" (the
small-model layout: params replicated, the "model" axis carries batch).
``optimizer`` and ``tie_lambda`` default to the reference's (Adam at lr
1e-3, weight decay 1e-5; 1e-4). Prefill returns the next token; decode
takes a Python int ``pos`` and writes its cache shards in place.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.common.axes import AxisCtx
from repro_torch.common.pytree import (leaf_paths, tree_from_paths,
                                       tree_leaves, tree_map)
from repro_torch.configs.base import (INPUT_SHAPES, LONG_CONTEXT_WINDOW,
                                      ModelConfig, ShapeConfig)
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.sharding.specs import (_path_str, batch_axes, batch_specs,
                                        cache_specs, param_spec,
                                        tree_param_specs)
from repro_torch.train import trainer as TR
from repro_torch.train.optimizer import adam

ENC_PAD = 1536   # whisper's 1500 stub frames padded to 1536: TP divides it
METRIC_SPECS = {"loss": (), "ce": (), "moe_aux": (), "grad_norm": ()}


def axis_ctx(cfg: ModelConfig, multi_pod: bool, mesh=None) -> AxisCtx:
    return AxisCtx(tp="model", dp="data", pod="pod" if multi_pod else None,
                   fsdp=cfg.fsdp, mesh=mesh)


class LocalStep:
    """A step over this rank's shards on ``mesh`` (``ax`` names its axes);
    ``out_specs`` lays out what it returns."""

    def __init__(self, fn, mesh, ax: AxisCtx, out_specs):
        self.fn, self.mesh, self.ax, self.out_specs = fn, mesh, ax, out_specs

    def __call__(self, *args):
        return self.fn(*args)


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors: shapes and dtypes, never allocated)
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_struct(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        S -= cfg.n_vision_tokens
    batch = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = _meta((B, cfg.n_vision_tokens, cfg.d_model),
                                       torch.bfloat16)
    elif cfg.family == "encdec":
        batch["frames"] = _meta((B, ENC_PAD, cfg.d_model), torch.bfloat16)
    return batch


def prefill_batch_struct(cfg: ModelConfig, shape: ShapeConfig):
    b = train_batch_struct(cfg, shape)
    b.pop("labels")
    return b


def decode_inputs_struct(cfg: ModelConfig, shape: ShapeConfig,
                         kv_dtype=torch.bfloat16):
    """(cache, token, pos) structs. long_500k keeps a ring of the sliding
    window's size for the attention caches (the SSM states are O(1))."""
    B, S = shape.global_batch, shape.seq_len
    ring = shape.name == "long_500k" and cfg.family not in ("ssm",)
    cache = lm.init_cache(cfg, B, LONG_CONTEXT_WINDOW if ring else S,
                          enc_seq=ENC_PAD, dtype=kv_dtype, device="meta")
    return cache, _meta((B, 1), torch.int32), _meta((), torch.int32)


def input_specs(arch_cfg: ModelConfig, shape_name: str):
    """Meta-tensor stand-ins for every model input of (arch, input
    shape)."""
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "train":
        return train_batch_struct(arch_cfg, shape)
    if shape.mode == "prefill":
        return prefill_batch_struct(arch_cfg, shape)
    cache, token, pos = decode_inputs_struct(arch_cfg, shape)
    return {"cache": cache, "token": token, "pos": pos}


def abstract_train_state(cfg: ModelConfig, tp: int, optimizer=None):
    """The FedSTIL train state (frozen, B, trainable, opt_state) as meta
    tensors, q heads padded for ``tp``."""
    st = TR.init_train_state(cfg, L.SHAPES_ONLY, tp=tp, optimizer=(
        optimizer or adam(lr=1e-3, weight_decay=1e-5)))
    return st.frozen, st.B, st.trainable, st.opt_state


def opt_state_specs(cfg: ModelConfig, opt_state, **kw):
    """Specs of one model's optimizer state (a stack of one: every moment
    leads with a dim of 1, as the count does): each moment laid out as its
    parameter."""
    return tree_from_paths(leaf_paths(opt_state), [
        (None,) + param_spec(cfg, _path_str(p), t.shape[1:], **kw)
        for p, t in zip(leaf_paths(opt_state), tree_leaves(opt_state))])


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def _replicated(tree):
    return tree_map(lambda t: (None,) * t.dim(), tree)


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
                     multi_pod: bool, layout: str = "tp", optimizer=None,
                     tie_lambda: float = 1e-4):
    """layout="tp": Megatron TP over the model axis (the default).
    layout="dp": the small-model layout: the model axis carries BATCH
    (params replicated, no activation collective; only the gradient's
    sum over the batch axes remains)."""
    tp, dp = mesh.size("model"), mesh.size("data")
    if layout == "dp":
        ax = AxisCtx(tp=None, dp="data", pod="pod" if multi_pod else None,
                     dp2="model", fsdp=False, mesh=mesh)
        tp_build = 1
    else:
        ax = axis_ctx(cfg, multi_pod, mesh)
        tp_build = tp
    opt = optimizer or adam(lr=1e-3, weight_decay=1e-5)
    frozen, B, trainable, opt_state = abstract_train_state(cfg, tp_build, opt)
    batch = train_batch_struct(cfg, shape)

    if layout == "dp":
        if shape.global_batch % (dp * tp * (2 if multi_pod else 1)):
            raise ValueError("dp layout needs batch divisible by all axes")
        baxes = ("pod", "data", "model") if multi_pod else ("data", "model")
        bspec = tree_map(lambda t: (baxes,) + (None,) * (t.dim() - 1), batch)
        rep = _replicated
        in_specs = (rep(frozen), rep(B), rep(trainable), rep(opt_state),
                    bspec)
        out_specs = (rep(trainable), rep(opt_state), METRIC_SPECS)
    else:
        sp = functools.partial(tree_param_specs, cfg, tp_size=tp)
        osp = opt_state_specs(cfg, opt_state, tp_size=tp)
        in_specs = (sp(frozen), sp(B), sp(trainable), osp,
                    batch_specs(cfg, batch, shape.global_batch, dp,
                                multi_pod))
        out_specs = (sp(trainable), osp, METRIC_SPECS)

    step = TR.make_train_step(cfg, optimizer=opt, ax=ax, window=0,
                              tie_lambda=tie_lambda)
    return (LocalStep(step, mesh, ax, out_specs),
            (frozen, B, trainable, opt_state, batch), in_specs)


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
                       multi_pod: bool):
    """The forward over the prompt -> the next token (B, 1) int32."""
    tp, dp = mesh.size("model"), mesh.size("data")
    ax = axis_ctx(cfg, multi_pod, mesh)
    params = lm.init_params(cfg, L.SHAPES_ONLY, tp=tp)
    batch = prefill_batch_struct(cfg, shape)

    def prefill(params, batch):
        with torch.no_grad():
            x, _ = lm.forward(cfg, params, batch, ax)
            tok, _ = L.lm_head_logits(cfg, params["head"], x[:, -1:, :], ax)
        return tok.to(torch.int32)

    in_specs = (tree_param_specs(cfg, params, tp_size=tp),
                batch_specs(cfg, batch, shape.global_batch, dp, multi_pod))
    out_specs = (batch_axes(shape.global_batch, dp, multi_pod), None)
    return LocalStep(prefill, mesh, ax, out_specs), (params, batch), in_specs


def build_decode_step(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
                      multi_pod: bool, weight_stationary: bool = False,
                      kv_dtype=torch.bfloat16):
    """One greedy decode step (params, cache, token, pos) -> (next token,
    cache); long_500k decodes against a ring of ``LONG_CONTEXT_WINDOW``
    slots. ``weight_stationary``: FSDP weights stay split and the
    activations move (``layers.ws_colshard_matmul``)."""
    tp, dp = mesh.size("model"), mesh.size("data")
    ax = axis_ctx(cfg, multi_pod, mesh)
    if weight_stationary:
        ax = dataclasses.replace(ax, decode_ws=True)
    ring = shape.name == "long_500k" and cfg.family not in ("ssm",)
    window = LONG_CONTEXT_WINDOW if shape.name == "long_500k" else 0
    params = lm.init_params(cfg, L.SHAPES_ONLY, tp=tp)
    cache, token, pos = decode_inputs_struct(cfg, shape, kv_dtype=kv_dtype)

    def serve_step(params, cache, token, pos):
        with torch.no_grad():
            return lm.decode_step(cfg, params, cache, token, pos, ax,
                                  window=window, ring=ring, enc_len=ENC_PAD)

    c_specs = cache_specs(cfg, cache, shape.global_batch, dp, multi_pod)
    b_axes = batch_axes(shape.global_batch, dp, multi_pod)
    in_specs = (tree_param_specs(cfg, params, tp_size=tp), c_specs,
                (b_axes, None), ())
    out_specs = ((b_axes, None), c_specs)
    return (LocalStep(serve_step, mesh, ax, out_specs),
            (params, cache, token, pos), in_specs)


def build_step(cfg: ModelConfig, mesh, shape_name: str, *, multi_pod: bool):
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "train":
        return build_train_step(cfg, mesh, shape, multi_pod=multi_pod)
    if shape.mode == "prefill":
        return build_prefill_step(cfg, mesh, shape, multi_pod=multi_pod)
    return build_decode_step(cfg, mesh, shape, multi_pod=multi_pod)
