"""LM trainer: the FedSTIL split step at architecture scale (frozen trunk;
the adaptive last block + head trained as theta = B ⊙ alpha + A), the port
of ``repro/train/trainer.py``, unsharded or on a mesh.

Gradients flow only into (alpha, A): the trunk's parameters and the
embedding do not require them, so autograd records nothing there and its
attention takes the forward kernel alone; the adaptive block's attention
takes the differentiable op (forward + logsumexp, then dQ and dK/dV).

Adam and clipping are the reference's unstacked ones (a scalar step
count, one global norm), run as a stack of one model on
``train/optimizer.py``'s stacked Adam: every leaf gets a leading axis of
1 (a view), the same arithmetic with no second optimizer. ``opt_state``
therefore holds (1, ...) moments and a (1,) count. The tying term's
``|a|`` is ``where(a >= 0, a, -a)``, whose slope at 0 is +1 as JAX's
``abs`` gives it (``core/tying.py``): A is exactly 0 on the first step.

On a mesh (an ``AxisCtx`` that names axes; ``launch/steps.py`` builds
it) every rank computes on its local shards, and a step's gradient is the
unsharded step's on every layout:

  * the loss is the mean over the data axes, taken inside the
    differentiated function (``pmean_dp``), as the reference does;
  * each param leaf enters the model marked varying over the data axes
    its layout does not split (``pvary``): its gradient is summed over
    them, the sum JAX's ``shard_map`` inserts on a replicated param (an
    FSDP leaf's is the reduce-scatter of its gather);
  * the tying term is an l1 over the local shards, added outside that
    mark, so its gradient (the sign) is neither summed over data nor
    scales the cross-entropy's. The reference's sharded step adds it to
    a TP-invariant loss, which makes the loss TP-varying and sums the
    cross-entropy's cotangent over TP: its gradient comes out x TP there
    (ROADMAP Queue 3; pinned by ``tests/test_torch_tp.py``);
  * no global-norm clip under TP (``grad_norm`` reports 0), as the
    reference: the leaves are TP-split, and a local norm would be wrong.

A split step is the span ``train.step``, partitioned by the spans
``train.combine``, ``lm.trunk``, ``lm.adaptive``, ``lm.head`` (the final
norm, the fp32 logits and cross-entropy, then the mean over data and the
tying term), ``train.head_bwd``, ``train.adaptive_bwd``, ``train.clip``
and ``train.adam`` (the update and its application): ``obs.trace``'s
tiling spans, recorded while a tracer is active or ``torch.profiler``
records.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.axes import AxisCtx, UNSHARDED
from repro_torch.common.pytree import (leaf_paths, tree_from_paths,
                                       tree_leaves, tree_map)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptive import (combine, init_adaptive, merge_params,
                                       split_params)
from repro_torch.core.tying import _abs
from repro_torch.models import lm
from repro_torch.obs import trace as obs
from repro_torch.sharding.specs import tree_param_specs
from repro_torch.train.optimizer import (adam, apply_updates,
                                         clip_by_global_norm)


@dataclasses.dataclass
class TrainState:
    frozen: Any                # extraction-layer params (never updated)
    B: Any                     # server-provided base for adaptive layers
    trainable: Any             # {"alpha": ..., "A": ...}
    opt_state: Any             # stacked-of-one Adam state

    def theta(self):
        return combine(self.B, self.trainable["alpha"], self.trainable["A"])

    def full_params(self):
        return merge_params(self.frozen, self.theta())


def _stack1(tree):
    return tree_map(lambda x: x.unsqueeze(0), tree)


def _unstack1(tree):
    return tree_map(lambda x: x.squeeze(0), tree)


def init_opt_state(optimizer, params):
    """The optimizer's state for one model's params (a stack of one)."""
    return optimizer.init(_stack1(params))


def _opt_step(optimizer, params, grads, opt_state, ax: AxisCtx):
    """Global-norm clip to 1.0 (unsharded and the dp layout: not under
    TP), one optimizer update, the new params: -> (params, opt_state, grad
    norm before clipping, 0 under TP)."""
    grads = _stack1(grads)
    with obs.span("train.clip", cat="phase", tile=True):
        if ax.tp is None:
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            gnorm = gnorm[0]
        else:
            gnorm = torch.zeros((), device=tree_leaves(grads)[0].device)
    with obs.span("train.adam", cat="phase", tile=True):
        updates, opt_state = optimizer.update(grads, opt_state,
                                              _stack1(params))
        return apply_updates(params, _unstack1(updates)), opt_state, gnorm


def _data_varying(cfg: ModelConfig, tree, ax: AxisCtx):
    """Each leaf marked varying over the data axes its layout does not
    split (all of them, but "data" for an FSDP leaf)."""
    axes = ax.dp_axes
    if not axes:
        return tree
    if not ax.fsdp:
        return tree_map(lambda t: ax.pvary(t, axes), tree)

    def one(t, spec):
        split = {a for e in spec if e
                 for a in (e if isinstance(e, tuple) else (e,))}
        return ax.pvary(t, tuple(a for a in axes if a not in split))

    return tree_map(one, tree, tree_param_specs(cfg, tree,
                                                tp_size=ax.tp_size))


def init_train_state(cfg: ModelConfig, gen: torch.Generator, tp: int = 1,
                     optimizer=None) -> TrainState:
    """Random weights from ``gen`` (on its device; ``layers.SHAPES_ONLY``:
    meta tensors), q heads padded for ``tp``, split into the frozen trunk
    and the adaptive slice, which starts at B = theta0, alpha = 1, A =
    0."""
    params = lm.init_params(cfg, gen, tp=tp)
    return train_state_from_params(cfg, params, optimizer)


def train_state_from_params(cfg: ModelConfig, params, optimizer=None):
    """A ``TrainState`` around given LM params (for example the JAX
    package's, carried across by ``core.convert.lm_params_from_jax``)."""
    frozen, adaptive = split_params(cfg, params)
    ad = init_adaptive(adaptive)
    opt = optimizer or adam(lr=1e-3, weight_decay=1e-5)
    return TrainState(frozen=frozen, B=ad.B, trainable=ad.trainable(),
                      opt_state=init_opt_state(opt, ad.trainable()))


def adaptive_loss_and_grads(cfg: ModelConfig, frozen, B, trainable, batch,
                            ax: AxisCtx = UNSHARDED, *, window: int = 0,
                            tie_lambda: float = 0.0):
    """The split step's objective and its gradient in (alpha, A):
    -> ((loss, ce, aux), grads shaped as ``trainable``). The reported
    loss excludes the tying term, as in the reference. ``window > 0``:
    sliding-window attention. On a mesh: local shards in, the rank's
    shards of the unsharded gradient out."""
    with obs.span("train.combine", cat="phase", tile=True):
        paths = leaf_paths(trainable)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(trainable)]
        tr = tree_from_paths(paths, leaves)
        theta = _data_varying(cfg, combine(B, tr["alpha"], tr["A"]), ax)
    head_inputs = []
    total, (ce, aux) = lm.loss_fn(
        cfg, merge_params(frozen, theta), batch, ax, window=window,
        head_input=head_inputs.append if obs.recording() else None)
    with obs.span("lm.head", cat="phase", tile=True):
        total = ax.pmean_dp(total)
        reported = total.detach()
        if tie_lambda:
            l1 = sum(torch.sum(_abs(a)) for a in tree_leaves(tr["A"]))
            total = total + tie_lambda * l1
    grads = _grad(total, leaves, head_inputs)
    return ((reported, ax.pmean_dp(ce).detach(), ax.pmean_dp(aux).detach()),
            tree_from_paths(paths, list(grads)))


def _grad(total, leaves, head_inputs):
    """``torch.autograd.grad(total, leaves)``; with ``head_inputs`` (the
    head's input, given only while spans record) in the spans
    ``train.head_bwd``, until a hook on the head's input sees its gradient
    (on autograd's device thread, while this one waits), then
    ``train.adaptive_bwd``."""
    if not head_inputs:
        return torch.autograd.grad(total, leaves)
    live = [obs.span("train.head_bwd", cat="phase", tile=True)]
    live[0].__enter__()

    def reached(grad):
        live[0].__exit__(None, None, None)
        live[0] = obs.span("train.adaptive_bwd", cat="phase", tile=True)
        live[0].__enter__()

    hooks = [x.register_hook(reached) for x in head_inputs]
    try:
        return torch.autograd.grad(total, leaves)
    finally:
        for h in hooks:
            h.remove()
        live[0].__exit__(None, None, None)


def make_train_step(cfg: ModelConfig, optimizer=None, ax: AxisCtx = UNSHARDED,
                    *, window: int = 0, tie_lambda: float = 0.0):
    """Returns train_step(frozen, B, trainable, opt_state, batch) ->
    (trainable, opt_state, metrics). Grads flow only into (alpha, A)."""
    opt = optimizer or adam(lr=1e-3, weight_decay=1e-5)

    def train_step(frozen, B, trainable, opt_state, batch):
        with obs.span("train.step", cat="step"):
            (loss, ce, aux), grads = adaptive_loss_and_grads(
                cfg, frozen, B, trainable, batch, ax, window=window,
                tie_lambda=tie_lambda)
            trainable, opt_state, gnorm = _opt_step(opt, trainable, grads,
                                                    opt_state, ax)
        return trainable, opt_state, {"loss": loss, "ce": ce, "moe_aux": aux,
                                      "grad_norm": gnorm}

    return train_step


def make_full_train_step(cfg: ModelConfig, optimizer=None,
                         ax: AxisCtx = UNSHARDED, *, window: int = 0):
    """Beyond-paper: full fine-tuning of every parameter. Returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics);
    ``opt_state`` from ``init_opt_state(optimizer, params)``."""
    opt = optimizer or adam(lr=3e-4)

    def train_step(params, opt_state, batch):
        paths = leaf_paths(params)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        p = _data_varying(cfg, tree_from_paths(paths, leaves), ax)
        total, (ce, aux) = lm.loss_fn(cfg, p, batch, ax, window=window)
        loss = ax.pmean_dp(total)
        grads = tree_from_paths(paths, list(torch.autograd.grad(loss, leaves)))
        params, opt_state, gnorm = _opt_step(opt, params, grads, opt_state,
                                             ax)
        return params, opt_state, {"loss": loss.detach(),
                                   "ce": ax.pmean_dp(ce).detach(),
                                   "grad_norm": gnorm}

    return train_step
