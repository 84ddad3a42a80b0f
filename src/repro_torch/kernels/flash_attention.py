"""CUDA kernel wrappers: flash attention's four stages
(``csrc/flash_attention.cu``; the bf16 forwards ``csrc/flash_fwd_sm90.cu``),
each replacing a Pallas TPU kernel:

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

The two forwards pick their kernel by dtype: bf16 runs on the tensor
cores (wgmma + TMA, ``flash_fwd_sm90.cu``), fp32 on the FMA kernel of
``flash_attention.cu`` (TF32 products would miss the fp32 bars). Each
counts every launch in ``launches`` and the tensor-core ones also in
``tc_launches``.
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
# q k v o lse (null: the forward alone), B .. window, scale, stream
_TC_ARGS = (_P,) * 5 + (_I,) * 8 + (ctypes.c_float, _P)


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
    """The forwards' rule by dtype: bf16 on the tensor-core kernel, fp32
    on the FMA kernel."""
    return dtype == torch.bfloat16


def _forward(name, q, k, v, *, causal, window, with_lse):
    """Launch the forward of q's dtype -> (o, lse or None)."""
    dims = _dims(q, k, v, causal=causal, window=window)
    o = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    lse_ptr = () if lse is None else (lse.data_ptr(),)
    if uses_tensor_cores(q.dtype):
        fn = _build.kernel("flash_fwd_sm90", "repro_flash_fwd_sm90",
                           _TC_ARGS)
        rc = fn(*ptrs, lse_ptr[0] if lse_ptr else None, *dims[:-1],
                _stream(q.device))
    else:
        fn = _build.kernel("flash_attention", "repro_flash_fwd_lse"
                           if with_lse else "repro_flash_fwd",
                           (_P,) * (4 + len(lse_ptr)) + _DIMS)
        rc = fn(*ptrs, *lse_ptr, *dims, _stream(q.device))
    _build.raise_on_error(name, rc)
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


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool,
                       window: int = 0):
    """dQ from dO, the forward's lse and delta = rowsum(O dO)."""
    dims = _dims(q, k, v, causal=causal, window=window)
    _build.check_operand("do", do, q.dtype, tuple(q.shape), q.device)
    _stats(q, "lse", lse)
    _stats(q, "delta", delta)
    dq = torch.empty_like(q)
    fn = _build.kernel("flash_attention", "repro_flash_dq",
                       (_P,) * 7 + _DIMS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
            _stream(q.device))
    _build.raise_on_error("flash_attention_dq", rc)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool,
                        window: int = 0):
    """(dK, dV), each summed over the R q heads of its kv head."""
    dims = _dims(q, k, v, causal=causal, window=window)
    _build.check_operand("do", do, q.dtype, tuple(q.shape), q.device)
    _stats(q, "lse", lse)
    _stats(q, "delta", delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.kernel("flash_attention", "repro_flash_dkv",
                       (_P,) * 8 + _DIMS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims, _stream(q.device))
    _build.raise_on_error("flash_attention_dkv", rc)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0
flash_attention_fwd_lse.launches = 0
flash_attention_fwd_lse.tc_launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
