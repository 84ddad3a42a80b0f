"""CUDA kernel wrapper: the server's fused Eq. 5 -> 6 tail
(``csrc/relevance_aggregate.cu``; replaces
``repro/kernels/relevance_aggregate.py:fused_relevance_aggregate``).

    Wn = row-normalized W with the diagonal masked (zero rows stay zero)
    B  = Wn @ Theta

Takes CUDA tensors only; ``ops.fused_relevance_aggregate`` sends CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_void_p)


def fused_relevance_aggregate(w, thetas):
    """w (C, C) raw relevance, thetas (C, P), both fp32 -> (B (C, P) fp32,
    Wn (C, C) fp32)."""
    if w.dim() != 2 or thetas.dim() != 2:
        raise ValueError(f"expected w (C, C) and thetas (C, P), got "
                         f"{tuple(w.shape)} and {tuple(thetas.shape)}")
    C, P = thetas.shape
    dev = thetas.device
    _build.check_operand("w", w, torch.float32, (C, C), dev)
    _build.check_operand("thetas", thetas, torch.float32, (C, P), dev)
    b = torch.empty((C, P), dtype=torch.float32, device=dev)
    wn = torch.empty((C, C), dtype=torch.float32, device=dev)
    if C == 0:
        return b, wn
    fn = _build.kernel("relevance_aggregate",
                       "repro_fused_relevance_aggregate", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(w.data_ptr(), thetas.data_ptr(), b.data_ptr(), wn.data_ptr(),
                C, P, stream)
    _build.raise_on_error("fused_relevance_aggregate", rc)
    fused_relevance_aggregate.launches += 1
    return b, wn


fused_relevance_aggregate.launches = 0
