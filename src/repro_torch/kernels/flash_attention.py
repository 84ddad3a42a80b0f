"""CUDA kernel wrappers: flash attention's four stages
(``csrc/flash_attention.cu``; in bf16 ``csrc/flash_fwd_sm90.cu`` and
``csrc/flash_bwd_sm90.cu``), each replacing a Pallas TPU kernel:

  * ``flash_attention_fwd``     o                      (replaces
    ``repro/kernels/flash_attention.py:flash_attention``)
  * ``flash_attention_fwd_lse`` (o, lse)               (``flash_attention_bwd.py:_fwd``)
  * ``flash_attention_dq``      dq                     (``flash_attention_bwd.py:_dq_kernel``)
  * ``flash_attention_dkv``     (dk, dv)               (``flash_attention_bwd.py:_dkv_kernel``)

q (B, Hq, Sq, hd), k and v (B, Hkv, Sk, hd) with Hq a multiple of Hkv (q
head h reads kv head h // R), all fp32 or all bf16, contiguous, on one
CUDA device; hd 64 or 128. Outputs in the operands' dtype, lse and delta
fp32 (B, Hq, Sq). The causal mask is aligned top-left (``ref.py`` states
the convention). Takes CUDA tensors only; ``ops`` sends CPU tensors to
the plain versions in ``ref``.

Every stage picks its kernel by dtype: bf16 runs on the tensor cores
(wgmma + TMA: the forwards in ``flash_fwd_sm90.cu``, dQ and dK/dV in
``flash_bwd_sm90.cu``), fp32 on the FMA kernels of ``flash_attention.cu``
(TF32 products would miss the fp32 bars). Each wrapper counts every launch
in ``launches`` and the tensor-core ones also in ``tc_launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
# B Hq Hkv Sq Sk hd causal window, scale, bf16, stream
_DIMS = (_I,) * 8 + (ctypes.c_float, _I, _P)
_DTYPES = (torch.float32, torch.bfloat16)
# the tensor-core kernels: pointers, then B .. window, scale, stream
_TC_DIMS = (_I,) * 8 + (ctypes.c_float, _P)


def _dims(q, k, v, *, causal, window):
    """Check q, k, v and return the kernels' int arguments."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: expected (B, H, S, hd)")
    B, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention: dtype {q.dtype}, the kernels "
                        "take float32 or bfloat16")
    if hd not in (64, 128):
        raise ValueError(f"flash attention: head dim {hd}, the kernels "
                         "take 64 or 128")
    if hkv < 1 or hq % hkv or sq < 1 or sk < 1 or B * hq > 65535:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: q heads must be a multiple "
                         "of kv heads, S >= 1, B * Hq <= 65535")
    if q.numel() >= 1 << 31 or k.numel() >= 1 << 31:
        raise ValueError("flash attention: an operand of 2^31 elements or "
                         "more")
    dev = q.device
    _build.check_operand("q", q, q.dtype, (B, hq, sq, hd), dev)
    _build.check_operand("k", k, q.dtype, (B, hkv, sk, hd), dev)
    _build.check_operand("v", v, q.dtype, (B, hkv, sk, hd), dev)
    return (B, hq, hkv, sq, sk, hd, int(bool(causal)), int(window),
            ctypes.c_float(1.0 / math.sqrt(hd)), int(q.dtype == torch.bfloat16))


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def _stats(q, name, t):
    B, hq, sq, _ = q.shape
    _build.check_operand(name, t, torch.float32, (B, hq, sq), q.device)


def uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Every stage's rule by dtype: bf16 on the tensor-core kernels, fp32
    on the FMA kernels."""
    return dtype == torch.bfloat16


def _launch(name, q, ptrs, dims, tc, fma):
    """Launch stage ``name`` on pointers ``ptrs`` (None: a null pointer)
    and the int arguments ``dims``: bf16 on the tensor-core kernel ``tc``
    = (source, symbol), fp32 on ``flash_attention.cu``'s ``fma``."""
    if uses_tensor_cores(q.dtype):
        fn = _build.kernel(*tc, (_P,) * len(ptrs) + _TC_DIMS)
        rc = fn(*ptrs, *dims[:-1], _stream(q.device))
    else:
        fn = _build.kernel("flash_attention", fma, (_P,) * len(ptrs) + _DIMS)
        rc = fn(*ptrs, *dims, _stream(q.device))
    _build.raise_on_error(name, rc)


def _forward(name, q, k, v, *, causal, window, with_lse):
    """Launch the forward of q's dtype -> (o, lse or None)."""
    dims = _dims(q, k, v, causal=causal, window=window)
    o = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if uses_tensor_cores(q.dtype):      # one kernel; a null lse: o alone
        ptrs += (None if lse is None else lse.data_ptr(),)
    elif lse is not None:
        ptrs += (lse.data_ptr(),)
    _launch(name, q, ptrs, dims, ("flash_fwd_sm90", "repro_flash_fwd_sm90"),
            "repro_flash_fwd_lse" if with_lse else "repro_flash_fwd")
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool, window: int = 0):
    """Attention alone: -> o (B, Hq, Sq, hd)."""
    o, _ = _forward("flash_attention_fwd", q, k, v, causal=causal,
                    window=window, with_lse=False)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.tc_launches += uses_tensor_cores(q.dtype)
    return o


def flash_attention_fwd_lse(q, k, v, *, causal: bool, window: int = 0):
    """Attention and its logsumexp: -> (o, lse (B, Hq, Sq) fp32)."""
    o, lse = _forward("flash_attention_fwd_lse", q, k, v, causal=causal,
                      window=window, with_lse=True)
    flash_attention_fwd_lse.launches += 1
    flash_attention_fwd_lse.tc_launches += uses_tensor_cores(q.dtype)
    return o, lse


def _backward_operands(q, k, v, do, lse, delta, *, causal, window):
    """Check the backward stages' operands -> the kernels' int
    arguments."""
    dims = _dims(q, k, v, causal=causal, window=window)
    _build.check_operand("do", do, q.dtype, tuple(q.shape), q.device)
    _stats(q, "lse", lse)
    _stats(q, "delta", delta)
    return dims


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool,
                       window: int = 0):
    """dQ from dO, the forward's lse and delta = rowsum(O dO)."""
    dims = _backward_operands(q, k, v, do, lse, delta, causal=causal,
                              window=window)
    dq = torch.empty_like(q)
    _launch("flash_attention_dq", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()), dims,
            ("flash_bwd_sm90", "repro_flash_dq_sm90"), "repro_flash_dq")
    flash_attention_dq.launches += 1
    flash_attention_dq.tc_launches += uses_tensor_cores(q.dtype)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool,
                        window: int = 0):
    """(dK, dV), each summed over the R q heads of its kv head."""
    dims = _backward_operands(q, k, v, do, lse, delta, causal=causal,
                              window=window)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attention_dkv", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            dims, ("flash_bwd_sm90", "repro_flash_dkv_sm90"),
            "repro_flash_dkv")
    flash_attention_dkv.launches += 1
    flash_attention_dkv.tc_launches += uses_tensor_cores(q.dtype)
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0
flash_attention_fwd_lse.launches = 0
flash_attention_fwd_lse.tc_launches = 0
flash_attention_dq.launches = 0
flash_attention_dq.tc_launches = 0
flash_attention_dkv.launches = 0
flash_attention_dkv.tc_launches = 0
