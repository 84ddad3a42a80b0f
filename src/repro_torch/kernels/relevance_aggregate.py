"""CUDA kernel wrappers: the server's Eq. 6 aggregate
(``csrc/relevance_aggregate.cu``; replace
``repro/kernels/relevance_aggregate.py:fused_relevance_aggregate`` and
``:relevance_aggregate``).

    fused:  Wn = row-normalized W with the diagonal masked (zero rows stay
            zero), B = Wn @ Theta          (the stacked server round)
    fused, column block lo..hi: the same Wn, B = Wn[:, lo:hi] @ Theta_r
            with Theta_r the rows lo..hi   (the sharded server round: one
                                            rank's partial product)
    plain:  B = W @ Theta, W (R, C) rows already normalized
                                            (the host server round)
    normalize: the fused entry's Wn alone   (no main-path caller)

The fused entry and its column-block form are one wrapper and one C entry
point: the first is the second at lo = 0, hi = C. Every entry runs one of
three variants of the product, which ``_plan`` picks from the shapes and
Theta's alignment: ``skinny`` (C at most ``SKINNY_MAX_C``: one launch
streams Theta, the fused entry normalizing W in every block), ``tiled``
(128 x 128 output tiles fed by TMA from a k-major copy of W's rows, or of
Wn's columns lo..hi, in scratch) and ``ragged`` (the same tile fed by
4-byte copies, where P % 4 != 0 or Theta's base is off 16 bytes and no
TMA map can be encoded).

Take CUDA tensors only; ``ops.fused_relevance_aggregate``,
``ops.relevance_aggregate`` and ``ops.normalize_relevance`` send CPU
tensors to the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

VARIANTS = ("skinny", "tiled", "ragged")     # the .cu's Variant codes
# the skinny variant's largest R and C: its shared memory holds W up to 32
# x 32, and it beat the tile at every C <= 32 on an H100 (chip_smoke's
# ``skinny_vs_tiled`` sweep times both at P = 57664)
SKINNY_MAX_C = 32
TILE_M = TILE_N = 128                        # output rows x columns a tile
SKINNY_THREADS = 128                         # one float4 column a thread
SKINNY_ROWS = 8                              # rows of B a skinny block


class Plan(NamedTuple):
    variant: str                             # one of VARIANTS
    grid: int                                # blocks of the product launch
    scratch: Optional[Tuple[int, int]]       # (C, ld): W's rows k-major


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(R: int, C: int, P: int, aligned: bool,
          skinny_max_c: int = SKINNY_MAX_C) -> Plan:
    """The variant, product grid and scratch shape for B (R, P) = W (R, C)
    @ Theta (C, P); ``aligned``: Theta's base is 16-byte aligned. The
    skinny variant keeps R <= ``skinny_max_c`` rows in registers. ld, the
    scratch's row length, is R rounded up to 4 (TMA strides are multiples
    of 16 bytes)."""
    aligned = aligned and P % 4 == 0
    if aligned and max(R, C) <= skinny_max_c:
        return Plan("skinny", max(1, _cdiv(P // 4, SKINNY_THREADS))
                    * _cdiv(R, SKINNY_ROWS), None)
    return Plan("tiled" if aligned else "ragged",
                _cdiv(R, TILE_M) * _cdiv(P, TILE_N), (C, _cdiv(R, 4) * 4))


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _scratch(plan: Plan, dev):
    """(tensor, ld) of a fresh scratch for the plan, (None, 0) for none.
    It may be freed as soon as the launch is queued: the caching allocator
    hands its memory only to later work on the same stream."""
    if plan.scratch is None:
        return None, 0
    wt = torch.empty(plan.scratch, dtype=torch.float32, device=dev)
    return wt, plan.scratch[1]


_FUSED_ARGS = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)


def _fused(w, thetas, plan: Plan, lo: int, hi: int):
    """Launch the fused entry on Wn's columns lo..hi under ``plan``: (B (C,
    P), Wn (C, C))."""
    C = w.shape[0]
    P = thetas.shape[1]
    dev = thetas.device
    b = torch.empty((C, P), dtype=torch.float32, device=dev)
    wn = torch.empty((C, C), dtype=torch.float32, device=dev)
    if C == 0:
        return b, wn
    wt, ld = _scratch(plan, dev)
    fn = _build.kernel("relevance_aggregate",
                       "repro_fused_relevance_aggregate", _FUSED_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(w.data_ptr(), thetas.data_ptr(), b.data_ptr(), wn.data_ptr(),
                None if wt is None else wt.data_ptr(), C, lo, hi, P,
                VARIANTS.index(plan.variant), ld, plan.grid, stream)
    _build.raise_on_error("fused_relevance_aggregate", rc)
    return b, wn


def fused_relevance_aggregate(w, thetas, lo: int = 0,
                              hi: Optional[int] = None):
    """w (C, C) raw relevance, thetas (hi - lo, P) the parameters of rows
    lo..hi (all C rows by default), both fp32 -> (B = Wn[:, lo:hi] @ thetas
    (C, P) fp32, the whole Wn (C, C) fp32), in one launch at C <=
    ``SKINNY_MAX_C``. On a column block, Wn is ``normalize_relevance``'s and
    B the plain entry's on ``Wn[:, lo:hi]``, bit for bit."""
    if w.dim() != 2 or thetas.dim() != 2:
        raise ValueError(f"expected w (C, C) and thetas (hi - lo, P), got "
                         f"{tuple(w.shape)} and {tuple(thetas.shape)}")
    C = w.shape[0]
    hi = C if hi is None else hi
    if not 0 <= lo < hi <= C:
        raise ValueError(f"column block [{lo}, {hi}) is empty or outside "
                         f"W's {C} columns")
    P = thetas.shape[1]
    dev = thetas.device
    _build.check_operand("w", w, torch.float32, (C, C), dev)
    _build.check_operand("thetas", thetas, torch.float32, (hi - lo, P), dev)
    out = _fused(w, thetas, _plan(C, hi - lo, P, _aligned(thetas)), lo, hi)
    fused_relevance_aggregate.launches += 1
    return out


fused_relevance_aggregate.launches = 0


_PLAIN_ARGS = (ctypes.c_void_p,) * 4 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)


def _plain(w, thetas, plan: Plan):
    """Launch the plain entry under ``plan``: B."""
    C, P = thetas.shape
    R = w.shape[0]
    dev = thetas.device
    b = torch.empty((R, P), dtype=torch.float32, device=dev)
    if b.numel() == 0:
        return b
    wt, ld = _scratch(plan, dev)
    fn = _build.kernel("relevance_aggregate", "repro_relevance_aggregate",
                       _PLAIN_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(w.data_ptr(), thetas.data_ptr(), b.data_ptr(),
                None if wt is None else wt.data_ptr(), R, C, P,
                VARIANTS.index(plan.variant), ld, plan.grid, stream)
    _build.raise_on_error("relevance_aggregate", rc)
    return b


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
    b = _plain(w, thetas, _plan(R, C, P, _aligned(thetas)))
    if b.numel():
        relevance_aggregate.launches += 1
    return b


relevance_aggregate.launches = 0


def normalize_relevance(w):
    """w (C, C) raw relevance fp32 -> Wn (C, C) fp32: the fused entry's Wn
    bit for bit (one ``normalize_kernel`` launch: the diagonal masked, rows
    normalized, rows that do not sum above zero kept zero)."""
    if w.dim() != 2:
        raise ValueError(f"expected w (C, C), got {tuple(w.shape)}")
    C = w.shape[0]
    _build.check_operand("w", w, torch.float32, (C, C), w.device)
    wn = torch.empty((C, C), dtype=torch.float32, device=w.device)
    if C == 0:
        return wn
    fn = _build.kernel("relevance_aggregate", "repro_normalize_relevance",
                       (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p))
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(w.data_ptr(), wn.data_ptr(), C, stream)
    _build.raise_on_error("normalize_relevance", rc)
    normalize_relevance.launches += 1
    return wn


normalize_relevance.launches = 0
