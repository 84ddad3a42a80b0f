"""CUDA kernel wrapper: FedSTIL's adaptive combine, Eq. 2, over one leaf
(``csrc/adaptive_combine.cu``; replaces
``repro/kernels/adaptive_combine.py:adaptive_combine``).

    theta = B * alpha + A          (elementwise, any shape, fp32 or bf16)

The product and the sum round separately (in bf16: each computed in fp32
and rounded to bf16, as eager PyTorch does), as in the plain version: the
kernel is bit-identical to it. Takes CUDA tensors only;
``ops.adaptive_combine`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p)
_SYMBOLS = {torch.float32: "repro_adaptive_combine",
            torch.bfloat16: "repro_adaptive_combine_bf16"}


def adaptive_combine(base, alpha, a):
    """Three fp32 (or three bf16) tensors of one shape -> base * alpha + a
    in their dtype."""
    shape = tuple(base.shape)
    dev = base.device
    dtype = base.dtype
    if dtype not in _SYMBOLS:
        raise TypeError(f"adaptive_combine: dtype {dtype}, the kernel takes "
                        "float32 or bfloat16")
    for name, t in (("base", base), ("alpha", alpha), ("a", a)):
        _build.check_operand(name, t, dtype, shape, dev)
    n = base.numel()
    if n >= 1 << 31:
        raise ValueError(f"adaptive_combine: {n} elements, the kernel "
                         "indexes fewer than 2^31")
    out = torch.empty(shape, dtype=dtype, device=dev)
    if n == 0:
        return out
    vec = int(all(t.data_ptr() % 16 == 0 for t in (base, alpha, a, out)))
    fn = _build.kernel("adaptive_combine", _SYMBOLS[dtype], _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(base.data_ptr(), alpha.data_ptr(), a.data_ptr(),
                out.data_ptr(), n, vec, stream)
    _build.raise_on_error("adaptive_combine", rc)
    adaptive_combine.launches += 1
    return out


adaptive_combine.launches = 0
