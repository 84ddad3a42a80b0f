"""CUDA kernel wrappers: query x gallery squared-euclidean distances
(``csrc/pairwise_dist.cu``; replace
``repro/kernels/pairwise_dist.py:batched_pairwise_dist`` and
``:pairwise_dist``).

    batched: dist[c, i, j] = |q[c, i]|^2 + |g[c, j]|^2 - 2 q[c, i] . g[c, j]
    2-D:     dist[i, j]    = |q[i]|^2 + |g[j]|^2 - 2 q[i] . g[j]

Take CUDA tensors only; ``ops.batched_pairwise_dist`` and
``ops.pairwise_dist`` send CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def batched_pairwise_dist(q, g):
    """(C, Q, D) x (C, G, D) fp32 -> (C, Q, G) fp32 squared distances."""
    if q.dim() != 3 or g.dim() != 3:
        raise ValueError(f"expected q (C, Q, D) and g (C, G, D), got "
                         f"{tuple(q.shape)} and {tuple(g.shape)}")
    C, Q, D = q.shape
    G = g.shape[1]
    dev = q.device
    _build.check_operand("q", q, torch.float32, (C, Q, D), dev)
    _build.check_operand("g", g, torch.float32, (C, G, D), dev)
    out = torch.empty((C, Q, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.kernel("pairwise_dist", "repro_batched_pairwise_dist", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), g.data_ptr(), out.data_ptr(), C, Q, G, D,
                stream)
    _build.raise_on_error("batched_pairwise_dist", rc)
    batched_pairwise_dist.launches += 1
    return out


batched_pairwise_dist.launches = 0


_ARGS_2D = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def pairwise_dist(q, g):
    """(Q, D) x (G, D) fp32 -> (Q, G) fp32 squared distances."""
    if q.dim() != 2 or g.dim() != 2:
        raise ValueError(f"expected q (Q, D) and g (G, D), got "
                         f"{tuple(q.shape)} and {tuple(g.shape)}")
    Q, D = q.shape
    G = g.shape[0]
    dev = q.device
    _build.check_operand("q", q, torch.float32, (Q, D), dev)
    _build.check_operand("g", g, torch.float32, (G, D), dev)
    out = torch.empty((Q, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.kernel("pairwise_dist", "repro_pairwise_dist", _ARGS_2D)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), g.data_ptr(), out.data_ptr(), Q, G, D, stream)
    _build.raise_on_error("pairwise_dist", rc)
    pairwise_dist.launches += 1
    return out


pairwise_dist.launches = 0
