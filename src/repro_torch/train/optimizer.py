"""Adam, SGD and global-norm clipping over stacked client parameters.

The port of ``adam``, ``apply_updates`` and ``clip_by_global_norm`` in
``repro/train/optimizer.py`` as the stacked engine uses them there (inside
a vmap over clients): every leaf carries a leading client axis and each
client is its own optimizer problem.

  * Adam keeps a per-client step ``count`` of shape (C,) and computes its
    bias corrections in fp32; weight decay is added to the update as
    ``u - lr * wd * p`` (not decoupled from the learning rate's sign).
  * Clipping is per client: client c's norm runs over every leaf of its
    own row, with the reference's ``1e-9``. ``clip_grad_norm_`` over the
    stacked tensors would clip across clients.
  * ``schedule`` (``cosine_schedule``) scales the learning rate by a
    function of each client's step count, in fp32, as the reference's
    ``adam(schedule=)``.

The reference's unstacked Adam (one model: a scalar ``count``) is the
same arithmetic on a stack of one: ``train/trainer.py`` runs the LM's
adaptive slice that way.

Trees are the nested dicts of ``common.pytree``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.common.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (updates, state)


def _per_client(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(C,) -> broadcastable against a (C, ...) leaf."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
         schedule: Optional[Callable] = None) -> Optimizer:
    def init(params):
        C = tree_leaves(params)[0].shape[0]
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "count": torch.zeros((C,), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        count = state["count"] + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g),
                     state["v"], grads)
        c = count.float()
        bc1 = 1 - b1 ** c          # fp32 powers on the device, no host copy
        bc2 = 1 - b2 ** c
        sched_lr = None if schedule is None else lr * schedule(count)

        def upd(mm, vv, p):
            step_lr = lr if schedule is None else _per_client(sched_lr, mm)
            u = -step_lr * (mm / _per_client(bc1, mm)) / (
                torch.sqrt(vv / _per_client(bc2, vv)) + eps)
            if weight_decay:
                u = u - step_lr * weight_decay * p
            return u

        return tree_map(upd, m, v, params), {"m": m, "v": v, "count": count}

    return Optimizer(init, update)


def sgd(lr=1e-2) -> Optimizer:
    """The reference's ``sgd`` without momentum: the update is -lr * g
    and the state empty. Elementwise, so a stack of clients or of one
    takes it as it is."""
    def init(params):
        return {}

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """Scale each client's gradients to global norm <= ``max_norm``.
    Returns (clipped grads, (C,) norms before clipping)."""
    sq = sum(torch.sum(torch.square(g.float()).flatten(1), 1)
             for g in tree_leaves(grads))
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * _per_client(scale, g), grads), gn


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to 1 over ``warmup`` steps, then a cosine decay to
    ``floor`` at ``total``: step counts (any shape, integer) -> fp32."""
    def fn(count):
        c = count.float()
        warm = c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(c < warmup, warm, cos)
    return fn
