"""CUDA kernel wrapper: pairwise KL task similarity, paper Eq. 4
(``csrc/kl_similarity.cu``; replaces
``repro/kernels/kl_similarity.py:kl_similarity``).

    S[i, j] = exp(-(h_i - softmax(a_i) . log_softmax(b_j)))

with both terms shifted by the same fp32 log D as the plain version
(``ref.kl_similarity_ref``). ``_plan`` picks the variant: ``small`` (one
launch, no scratch: each 64 x 64 tile works out the row statistics of its
own rows) or, where the grid of 128 x 128 tiles fills the card, ``split``
(a row pass
writes h, and p and logq k-major, to scratch; then 128 x 128 tiles fed
by TMA).

Takes CUDA tensors only; ``ops.kl_similarity`` sends CPU tensors to the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import kl_log_shift

VARIANTS = ("small", "split")                # the .cu's Variant codes
SPLIT_TILE = 128                             # the split tile's rows of a, b
# the split variant (a row pass, then 128 x 128 tiles) once its grid has a
# tile for each of an H100's 132 SMs: at C = 1000 it beat computing the
# statistics in every tile, at C <= 100 it lost (chip_smoke's
# ``kl_variants`` times both)
SPLIT_MIN_TILES = 132

_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_float,)
         + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


class Plan(NamedTuple):
    variant: str                             # one of VARIANTS
    vec: bool                                # the small tile loads b by float4
    ld: Optional[Tuple[int, int]]            # split: scratch rows of p, logq


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(N: int, M: int, D: int, aligned: bool,
          split_min_tiles: float = SPLIT_MIN_TILES) -> Plan:
    """The variant, load width and scratch for S (N, M) from a (N, D) and b
    (M, D); ``aligned``: b's base is 16-byte aligned. The split variant's
    scratch holds p (D, ldn) and logq (D, ldm) k-major, ldn and ldm N and M
    rounded up to 4 (TMA strides are multiples of 16 bytes); its tile loads
    them by TMA, whatever b's alignment. ``split_min_tiles`` forces a
    variant (chip_smoke's sweep)."""
    if _cdiv(N, SPLIT_TILE) * _cdiv(M, SPLIT_TILE) >= split_min_tiles:
        return Plan("split", False, (_cdiv(N, 4) * 4, _cdiv(M, 4) * 4))
    return Plan("small", aligned and D % 4 == 0, None)


def _launch(a, b, plan: Plan):
    """Launch the kernel(s) under ``plan``: S. The split variant's scratch
    may be freed once its launches are queued: the caching allocator hands
    its memory only to later work on the same stream."""
    N, D = a.shape
    M = b.shape[0]
    dev = a.device
    out = torch.empty((N, M), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    scratch, (ldn, ldm) = (None, None, None), plan.ld or (0, 0)
    if plan.ld:
        scratch = (torch.empty((D, ldn), dtype=torch.float32, device=dev),
                   torch.empty((N,), dtype=torch.float32, device=dev),
                   torch.empty((D, ldm), dtype=torch.float32, device=dev))
    fn = _build.kernel("kl_similarity", "repro_kl_similarity", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                *(None if t is None else t.data_ptr() for t in scratch),
                N, M, D, ldn, ldm, kl_log_shift(D),
                VARIANTS.index(plan.variant),
                int(plan.vec), stream)
    _build.raise_on_error("kl_similarity", rc)
    return out


def kl_similarity(a, b):
    """(N, D) x (M, D) fp32 -> (N, M) fp32 similarities in (0, 1]."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"expected a (N, D) and b (M, D), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    N, D = a.shape
    M = b.shape[0]
    if D < 1:
        raise ValueError("kl_similarity needs D >= 1")
    _build.check_operand("a", a, torch.float32, (N, D), a.device)
    _build.check_operand("b", b, torch.float32, (M, D), a.device)
    out = _launch(a, b, _plan(N, M, D, b.data_ptr() % 16 == 0))
    if out.numel():
        kl_similarity.launches += 1
    return out


kl_similarity.launches = 0
