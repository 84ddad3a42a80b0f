"""Personalized model aggregation on the parameter server (paper Eq. 6):

    B_i = sum_{j in C\\i} W_ij^(t) * theta_j

The port of ``repro/core/aggregation.py``, for the host engine's server
round over lists of per-client heads. The kernel form flattens the C heads
into one (C, P) matrix (``common.pytree.tree_stack_flatten``) and forms the
R requested bases in one product through ``kernels.ops.relevance_aggregate``
(the CUDA kernel for CUDA tensors, its plain version on the CPU);
``backend="loop"`` keeps the reference's per-leaf einsum, the allclose
oracle.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.pytree import (device_of, tree_map, tree_stack,
                                       tree_stack_flatten, tree_unstack,
                                       tree_unstack_unflatten)
from repro_torch.kernels import ops


def personalized_aggregate(thetas: Sequence, W, *,
                           backend: Optional[str] = None) -> List:
    """B_i = sum_j W[i, j] * theta_j.

    thetas: length-C list of heads (trees of tensors on one device); W:
    (R, C) relevance rows (R = C in the classic round; R < C when the
    server skips rows without relevant neighbours). Returns a length-R list
    of base trees. ``backend``: None = the kernel form by device, "loop" =
    the per-leaf einsum reference."""
    if backend not in (None, "loop"):
        raise ValueError(f"backend {backend!r}: None (kernels by device) or "
                         "'loop'")
    W = torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(
        device_of(thetas[0]))
    if backend == "loop":
        stacked = tree_stack(thetas)                      # leaves (C, ...)
        agg = tree_map(lambda x: torch.einsum("ij,j...->i...", W, x.float())
                       .to(x.dtype), stacked)
        return tree_unstack(agg, W.shape[0])
    flat, meta = tree_stack_flatten(thetas)               # (C, P)
    return tree_unstack_unflatten(ops.relevance_aggregate(W, flat), meta)


def fedavg_aggregate(thetas: Sequence, weights=None):
    """Uniform (or sample-count-weighted) FedAvg mean of the heads."""
    C = len(thetas)
    if weights is None:
        w = np.full((C,), 1.0 / C, np.float32)
    else:
        w = np.asarray(weights, np.float32)
        w = w / w.sum()
    w = torch.from_numpy(w).to(device_of(thetas[0]))
    return tree_map(lambda x: torch.einsum("j,j...->...", w, x.float())
                    .to(x.dtype), tree_stack(thetas))
