"""CUDA kernel wrappers: batched per-chunk int8 quantization and its inverse
(``csrc/quantize.cu``; replace ``repro/kernels/quantize.py:batched_quantize``
and ``:batched_dequantize``).

    scale[c, j] = max(|x[c, j*chunk:(j+1)*chunk]|) * fl32(1/127)   (0 -> 1.0)
    q[c, i]     = clip(round_half_even(x[c, i] / scale), -127, 127)
    out[c, i]   = q[c, i] * scale[c, i // chunk]                 (dequantize)

The serving index quantizes with ``chunk = feat_dim``: one scale per row;
the wire codec quantizes and dequantizes with chunk 256. ``_plan`` picks
the quantizer's variant: ``vector`` (16 elements a thread, a chunk a group
of lanes, codes stored 16, 8 or 4 bytes wide) or ``scalar`` (a warp a
chunk). Take CUDA tensors only; ``ops.batched_quantize`` /
``ops.batched_dequantize`` send CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

VARIANTS = ("scalar", "vector")              # the .cu's Variant codes
VEC_ELEMS = 16                               # elements a vector thread owns

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p)
_DEQ_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 2
             + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


class Plan(NamedTuple):
    variant: str                             # one of VARIANTS
    store: int                               # bytes a code store writes


def _plan(C: int, P: int, chunk: int, aligned: bool) -> Plan:
    """The quantizer's variant for x (C, P) in chunks of ``chunk``;
    ``aligned``: x's base is 16-byte aligned. The vector variant needs a
    chunk that is a power of two of at least 16 elements (its lanes, chunk /
    16 up to a warp, reduce by xor shuffles), whole float4 rows (P % 4 ==
    0), 32-bit offsets and at most 65535 rows (the grid's y); it stores a
    thread's 16 codes as one 16-byte store where every row starts on 16
    bytes (P % 16 == 0), else as two of 8 or four of 4."""
    pow2 = chunk >= VEC_ELEMS and chunk & (chunk - 1) == 0
    if (pow2 and aligned and P % 4 == 0 and P + chunk < 2 ** 31
            and C < 65536):
        return Plan("vector", 16 if P % 16 == 0 else 8 if P % 8 == 0 else 4)
    return Plan("scalar", 1)


def _quantize(x, chunk: int, plan: Plan):
    """Launch the quantizer under ``plan``: (codes, scales)."""
    C, P = x.shape
    nc = (P + chunk - 1) // chunk
    q = torch.empty((C, P), dtype=torch.int8, device=x.device)
    scales = torch.empty((C, nc), dtype=torch.float32, device=x.device)
    if C * nc == 0:
        return q, scales
    fn = _build.kernel("quantize", "repro_batched_quantize", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), C, P, chunk,
                VARIANTS.index(plan.variant), plan.store, stream)
    _build.raise_on_error("batched_quantize", rc)
    return q, scales


def batched_quantize(x: torch.Tensor, *, chunk: int = 256):
    """(C, P) fp32 -> ((C, P) int8, (C, ceil(P/chunk)) fp32 scales)."""
    if x.dim() != 2:
        raise ValueError(f"x: expected (C, P), got shape {tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    C, P = x.shape
    _build.check_operand("x", x, torch.float32, (C, P), x.device)
    q, scales = _quantize(x, chunk, _plan(C, P, chunk,
                                          x.data_ptr() % 16 == 0))
    if scales.numel():
        batched_quantize.launches += 1
    return q, scales


batched_quantize.launches = 0


def batched_dequantize(q: torch.Tensor, scales: torch.Tensor, *,
                       chunk: int = 256):
    """(C, P) int8 codes + (C, ceil(P/chunk)) fp32 scales -> (C, P) fp32."""
    if q.dim() != 2:
        raise ValueError(f"q: expected (C, P), got shape {tuple(q.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    C, P = q.shape
    dev = q.device
    nc = (P + chunk - 1) // chunk
    _build.check_operand("q", q, torch.int8, (C, P), dev)
    _build.check_operand("scales", scales, torch.float32, (C, nc), dev)
    if C * P >= 1 << 31:
        raise ValueError(f"batched_dequantize: {C * P} codes, the kernel "
                         "indexes fewer than 2^31")
    out = torch.empty((C, P), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    vec = int(P % 4 == 0 and chunk % 4 == 0 and q.data_ptr() % 4 == 0
              and out.data_ptr() % 16 == 0)
    fn = _build.kernel("quantize", "repro_batched_dequantize", _DEQ_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), C, P, chunk,
                vec, stream)
    _build.raise_on_error("batched_dequantize", rc)
    batched_dequantize.launches += 1
    return out


batched_dequantize.launches = 0
