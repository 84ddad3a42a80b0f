"""CUDA kernel wrapper: pairwise KL task similarity, paper Eq. 4
(``csrc/kl_similarity.cu``; replaces
``repro/kernels/kl_similarity.py:kl_similarity``).

    S[i, j] = exp(-(h_i - softmax(a_i) . log_softmax(b_j)))

with both terms shifted by the same fp32 log D as the plain version
(``ref.kl_similarity_ref``).

Takes CUDA tensors only; ``ops.kl_similarity`` sends CPU tensors to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import kl_log_shift

_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3
         + (ctypes.c_float, ctypes.c_void_p))


def kl_similarity(a, b):
    """(N, D) x (M, D) fp32 -> (N, M) fp32 similarities in (0, 1]."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"expected a (N, D) and b (M, D), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    N, D = a.shape
    M = b.shape[0]
    if D < 1:
        raise ValueError("kl_similarity needs D >= 1")
    dev = a.device
    _build.check_operand("a", a, torch.float32, (N, D), dev)
    _build.check_operand("b", b, torch.float32, (M, D), dev)
    out = torch.empty((N, M), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    p = torch.empty((N, D), dtype=torch.float32, device=dev)
    h = torch.empty((N,), dtype=torch.float32, device=dev)
    logq = torch.empty((M, D), dtype=torch.float32, device=dev)
    fn = _build.kernel("kl_similarity", "repro_kl_similarity", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), p.data_ptr(),
                h.data_ptr(), logq.data_ptr(), N, M, D, kl_log_shift(D),
                stream)
    _build.raise_on_error("kl_similarity", rc)
    kl_similarity.launches += 1
    return out


kl_similarity.launches = 0
