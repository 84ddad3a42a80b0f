"""Helpers over the port's parameter trees: dicts of tensors, possibly
nested (a FedSTIL client's trainable part is ``{"alpha": theta, "A":
theta}``, each theta a flat dict under dotted keys such as ``l1.w``).

Leaves are visited in the JAX package's ``jax.tree.flatten`` order: keys
sorted at every level, a dotted key compared part by part. The flattened
(C, P) columns therefore come out in the same order as
``repro.common.pytree.tree_flatten_stacked``: ``bn.bias, bn.scale,
head.w, l1.b, l1.w, l2.b, l2.w`` for an edge head.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _order(tree: Tree) -> List[str]:
    return sorted(tree, key=lambda k: k.split("."))


def tree_leaves(tree) -> List[Any]:
    """Every leaf, in ``jax.tree.flatten`` order."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in _order(tree) for leaf in tree_leaves(tree[k])]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def tree_bytes(tree) -> int:
    """Bytes of every leaf together (the communication accounting)."""
    return int(sum(l.numel() * l.element_size() if isinstance(l, torch.Tensor)
                   else np.asarray(l).nbytes for l in tree_leaves(tree)))


Meta = Tuple[List[str], List[Tuple[int, ...]], List[torch.dtype]]


def flatten_stacked(theta: Dict[str, torch.Tensor]):
    """Flat dict of (C, ...) tensors -> ((C, P) fp32 matrix, meta), columns
    in ``jax.tree.flatten`` order."""
    keys = _order(theta)
    C = theta[keys[0]].shape[0]
    mat = torch.cat([theta[k].reshape(C, -1).float() for k in keys], 1)
    meta = (keys, [tuple(theta[k].shape[1:]) for k in keys],
            [theta[k].dtype for k in keys])
    return mat, meta


def unflatten_stacked(mat: torch.Tensor, meta: Meta):
    """Inverse of ``flatten_stacked``: (C, P) -> flat dict of (C, ...)
    tensors in their own dtypes (views into ``mat`` where the dtype is
    already its own)."""
    keys, shapes, dtypes = meta
    C = mat.shape[0]
    out, off = {}, 0
    for k, s, dt in zip(keys, shapes, dtypes):
        n = int(np.prod(s)) if s else 1
        out[k] = mat[:, off:off + n].reshape((C,) + s).to(dt)
        off += n
    return out
