"""CUDA kernel wrapper: batched per-chunk int8 quantization
(``csrc/quantize.cu``; replaces ``repro/kernels/quantize.py:batched_quantize``).

    scale[c, j] = max(|x[c, j*chunk:(j+1)*chunk]|) * fl32(1/127)   (0 -> 1.0)
    q[c, i]     = clip(round_half_even(x[c, i] / scale), -127, 127)

The serving index calls it with ``chunk = feat_dim``: one scale per row.
Takes CUDA tensors only; ``ops.batched_quantize`` sends CPU tensors to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def batched_quantize(x: torch.Tensor, *, chunk: int = 256):
    """(C, P) fp32 -> ((C, P) int8, (C, ceil(P/chunk)) fp32 scales)."""
    if x.dim() != 2:
        raise ValueError(f"x: expected (C, P), got shape {tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    C, P = x.shape
    _build.check_operand("x", x, torch.float32, (C, P), x.device)
    nc = (P + chunk - 1) // chunk
    q = torch.empty((C, P), dtype=torch.int8, device=x.device)
    scales = torch.empty((C, nc), dtype=torch.float32, device=x.device)
    if C * nc == 0:
        return q, scales
    fn = _build.kernel("quantize", "repro_batched_quantize", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), C, P, chunk,
                stream)
    _build.raise_on_error("batched_quantize", rc)
    batched_quantize.launches += 1
    return q, scales


batched_quantize.launches = 0
