"""CUDA kernel wrappers: the server's Eq. 6 aggregate
(``csrc/relevance_aggregate.cu``; replace
``repro/kernels/relevance_aggregate.py:fused_relevance_aggregate`` and
``:relevance_aggregate``).

    fused:  Wn = row-normalized W with the diagonal masked (zero rows stay
            zero), B = Wn @ Theta          (the stacked server round)
    plain:  B = W @ Theta, W (R, C) rows already normalized, R <= C
                                            (the host server round)

Take CUDA tensors only; ``ops.fused_relevance_aggregate`` and
``ops.relevance_aggregate`` send CPU tensors to the plain versions.
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


_PLAIN_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2 + (
    ctypes.c_longlong, ctypes.c_void_p)


def relevance_aggregate(w, thetas):
    """w (R, C) relevance rows, thetas (C, P), both fp32 -> B (R, P) fp32."""
    if w.dim() != 2 or thetas.dim() != 2:
        raise ValueError(f"expected w (R, C) and thetas (C, P), got "
                         f"{tuple(w.shape)} and {tuple(thetas.shape)}")
    C, P = thetas.shape
    R = w.shape[0]
    dev = thetas.device
    _build.check_operand("w", w, torch.float32, (R, C), dev)
    _build.check_operand("thetas", thetas, torch.float32, (C, P), dev)
    b = torch.empty((R, P), dtype=torch.float32, device=dev)
    if b.numel() == 0:
        return b
    fn = _build.kernel("relevance_aggregate", "repro_relevance_aggregate",
                       _PLAIN_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(w.data_ptr(), thetas.data_ptr(), b.data_ptr(), R, C, P,
                stream)
    _build.raise_on_error("relevance_aggregate", rc)
    relevance_aggregate.launches += 1
    return b


relevance_aggregate.launches = 0
