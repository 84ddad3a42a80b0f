"""CUDA kernel wrapper: fp32 queries x int8-quantized gallery distances
(``csrc/int8_dist.cu``; replaces
``repro/kernels/int8_dist.py:batched_int8_pairwise_dist``).

    dist[c, b, g] = |q[c, b]|^2 + gn2[c, g] - 2 * ((q[c, b] . gq[c, g]) * gscale[c, g])

``_plan`` (``pairwise_dist._plan``, mode ``int8``) picks the variant:
``tile`` where F % 16 == 0 and the query and code bases are 16-byte
aligned, else ``ragged``. Takes CUDA tensors only;
``ops.batched_int8_pairwise_dist`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import VARIANTS, Plan, _aligned, _plan

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def _launch(q, gq, gscale, gn2, plan: Plan):
    """Launch the kernel under ``plan``: (C, B, G) distances."""
    C, B, F = q.shape
    G = gq.shape[1]
    dev = q.device
    out = torch.empty((C, B, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.kernel("int8_dist", "repro_batched_int8_pairwise_dist", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), gq.data_ptr(), gscale.data_ptr(),
                gn2.data_ptr(), out.data_ptr(), C, B, G, F,
                VARIANTS.index(plan.variant), stream)
    _build.raise_on_error("batched_int8_pairwise_dist", rc)
    return out


def batched_int8_pairwise_dist(q, gq, gscale, gn2):
    """(C, B, F) fp32 x ((C, G, F) int8, (C, G) scales, (C, G) squared
    norms) -> (C, B, G) fp32 squared distances to the dequantized rows."""
    if q.dim() != 3 or gq.dim() != 3:
        raise ValueError(f"expected q (C, B, F) and gq (C, G, F), got "
                         f"{tuple(q.shape)} and {tuple(gq.shape)}")
    C, B, F = q.shape
    G = gq.shape[1]
    dev = q.device
    _build.check_operand("q", q, torch.float32, (C, B, F), dev)
    _build.check_operand("gq", gq, torch.int8, (C, G, F), dev)
    _build.check_operand("gscale", gscale, torch.float32, (C, G), dev)
    _build.check_operand("gn2", gn2, torch.float32, (C, G), dev)
    out = _launch(q, gq, gscale, gn2,
                  _plan(C, B, G, F, "int8", _aligned(q, gq)))
    if out.numel():
        batched_int8_pairwise_dist.launches += 1
    return out


batched_int8_pairwise_dist.launches = 0
