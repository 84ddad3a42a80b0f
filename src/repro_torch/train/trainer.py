"""LM trainer: the FedSTIL split step at architecture scale (frozen trunk;
the adaptive last block + head trained as theta = B ⊙ alpha + A), the port
of ``repro/train/trainer.py``, unsharded.

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


def _opt_step(optimizer, params, grads, opt_state):
    """Global-norm clip to 1.0, one optimizer update, the new params:
    -> (params, opt_state, grad norm before clipping)."""
    grads, gnorm = clip_by_global_norm(_stack1(grads), 1.0)
    updates, opt_state = optimizer.update(grads, opt_state, _stack1(params))
    return apply_updates(params, _unstack1(updates)), opt_state, gnorm[0]


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     optimizer=None) -> TrainState:
    """Random weights from ``gen`` (on its device), split into the frozen
    trunk and the adaptive slice, which starts at B = theta0, alpha = 1,
    A = 0."""
    params = lm.init_params(cfg, gen)
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
    sliding-window attention."""
    paths = leaf_paths(trainable)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(trainable)]
    tr = tree_from_paths(paths, leaves)
    theta = combine(B, tr["alpha"], tr["A"])
    total, (ce, aux) = lm.loss_fn(cfg, merge_params(frozen, theta), batch,
                                  ax, window=window)
    total = ax.pmean_dp(total)
    reported = total.detach()
    if tie_lambda:
        l1 = sum(torch.sum(_abs(a)) for a in tree_leaves(tr["A"]))
        total = total + tie_lambda * l1
    grads = torch.autograd.grad(total, leaves)
    return ((reported, ax.pmean_dp(ce).detach(), ax.pmean_dp(aux).detach()),
            tree_from_paths(paths, list(grads)))


def make_train_step(cfg: ModelConfig, optimizer=None, ax: AxisCtx = UNSHARDED,
                    *, window: int = 0, tie_lambda: float = 0.0):
    """Returns train_step(frozen, B, trainable, opt_state, batch) ->
    (trainable, opt_state, metrics). Grads flow only into (alpha, A)."""
    opt = optimizer or adam(lr=1e-3, weight_decay=1e-5)

    def train_step(frozen, B, trainable, opt_state, batch):
        (loss, ce, aux), grads = adaptive_loss_and_grads(
            cfg, frozen, B, trainable, batch, ax, window=window,
            tie_lambda=tie_lambda)
        trainable, opt_state, gnorm = _opt_step(opt, trainable, grads,
                                                opt_state)
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
        total, (ce, aux) = lm.loss_fn(cfg, tree_from_paths(paths, leaves),
                                      batch, ax, window=window)
        loss = ax.pmean_dp(total)
        grads = tree_from_paths(paths, list(torch.autograd.grad(loss, leaves)))
        params, opt_state, gnorm = _opt_step(opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(),
                                   "ce": ax.pmean_dp(ce).detach(),
                                   "grad_norm": gnorm}

    return train_step
