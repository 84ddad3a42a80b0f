"""Helpers over the port's parameter trees: dicts of tensors, possibly
nested (a FedSTIL client's trainable part is ``{"alpha": theta, "A":
theta}``, each theta a flat dict under dotted keys such as ``l1.w``).

Leaves are visited in the JAX package's ``jax.tree.flatten`` order: keys
sorted at every level, a dotted key compared part by part, an integer key
(FedWeIT's neighbour dicts, keyed by client) by its value. The flattened
(C, P) columns therefore come out in the same order as
``repro.common.pytree.tree_flatten_stacked``: ``bn.bias, bn.scale,
head.w, l1.b, l1.w, l2.b, l2.w`` for an edge head.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _sort_key(k) -> list:
    """Integer keys by value (2 before 10), strings part by part."""
    return [int(k)] if isinstance(k, (int, np.integer)) else k.split(".")


def _order(tree: Tree) -> list:
    return sorted(tree, key=_sort_key)


def tree_leaves(tree) -> List[Any]:
    """Every leaf, in ``jax.tree.flatten`` order."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in _order(tree) for leaf in tree_leaves(tree[k])]


def leaf_paths(tree) -> List[Tuple[str, ...]]:
    """The key path of every leaf, in ``tree_leaves`` order (a tree that
    is a single leaf has the one path ``()``)."""
    if not isinstance(tree, dict):
        return [()]
    return [(k,) + p for k in _order(tree) for p in leaf_paths(tree[k])]


def tree_from_paths(paths, leaves):
    """Inverse of (``leaf_paths``, ``tree_leaves``): nested dicts."""
    if list(paths) == [()]:
        return leaves[0]
    out: Tree = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def device_of(tree) -> torch.device:
    """The device of a tree's first tensor leaf (the CPU for none)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def tree_stack(trees):
    """Length-C list of trees of one structure -> one tree whose leaves
    carry a leading C dim (the stacked-over-clients layout)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_slice(tree, i: int):
    """Client ``i``'s slice of a stacked tree (leaves lose the C dim)."""
    return tree_map(lambda x: x[i], tree)


def tree_unstack(tree, n: int):
    """Inverse of ``tree_stack``: the leading dim back into a list."""
    return [tree_slice(tree, i) for i in range(n)]


def tree_bytes(tree) -> int:
    """Bytes of every leaf together (the communication accounting)."""
    return int(sum(l.numel() * l.element_size() if isinstance(l, torch.Tensor)
                   else np.asarray(l).nbytes for l in tree_leaves(tree)))


Meta = Tuple[List[Any], List[Tuple[int, ...]], List[torch.dtype]]


def tree_flatten_stacked(tree):
    """Tree of (C, ...) tensors -> ((C, P) fp32 matrix, meta), columns in
    ``jax.tree.flatten`` order; meta holds each leaf's key path."""
    paths = leaf_paths(tree)
    leaves = tree_leaves(tree)
    C = leaves[0].shape[0]
    mat = torch.cat([leaf.reshape(C, -1).float() for leaf in leaves], 1)
    return mat, (paths, [tuple(leaf.shape[1:]) for leaf in leaves],
                 [leaf.dtype for leaf in leaves])


def tree_unflatten_stacked(mat: torch.Tensor, meta: Meta):
    """Inverse of ``tree_flatten_stacked``: (C, P) -> the tree of (C, ...)
    tensors in their own dtypes (views into ``mat`` where the dtype is
    already its own)."""
    paths, shapes, dtypes = meta
    C = mat.shape[0]
    leaves, off = [], 0
    for s, dt in zip(shapes, dtypes):
        n = int(np.prod(s)) if s else 1
        leaves.append(mat[:, off:off + n].reshape((C,) + s).to(dt))
        off += n
    return tree_from_paths(paths, leaves)


def tree_stack_flatten(trees):
    """Length-C list of trees of one structure -> ((C, P) fp32 matrix,
    meta): each tree's leaves flattened into one row, in ``tree_leaves``
    order; meta keeps the paths, shapes and dtypes."""
    return tree_flatten_stacked(tree_stack(trees))


def tree_unstack_unflatten(mat: torch.Tensor, meta: Meta):
    """(R, P) matrix -> length-R list of trees (inverse of
    ``tree_stack_flatten``), each leaf its own contiguous tensor."""
    return tree_unstack(tree_map(lambda x: x.contiguous(),
                                 tree_unflatten_stacked(mat, meta)),
                        mat.shape[0])


def flatten_stacked(theta: Dict[str, torch.Tensor]):
    """Flat dict of (C, ...) tensors -> ((C, P) fp32 matrix, meta), columns
    in ``jax.tree.flatten`` order; meta holds the keys."""
    mat, (paths, shapes, dtypes) = tree_flatten_stacked(theta)
    return mat, ([p[0] for p in paths], shapes, dtypes)


def unflatten_stacked(mat: torch.Tensor, meta: Meta):
    """Inverse of ``flatten_stacked``: (C, P) -> flat dict of (C, ...)
    tensors in their own dtypes."""
    keys, shapes, dtypes = meta
    return tree_unflatten_stacked(mat, ([(k,) for k in keys], shapes, dtypes))
