"""CUDA kernel wrappers: query x gallery squared-euclidean distances
(``csrc/pairwise_dist.cu``; replace
``repro/kernels/pairwise_dist.py:batched_pairwise_dist`` and
``:pairwise_dist``).

    batched: dist[c, i, j] = |q[c, i]|^2 + |g[c, j]|^2 - 2 q[c, i] . g[c, j]
    2-D:     dist[i, j]    = |q[i]|^2 + |g[j]|^2 - 2 q[i] . g[j]

All four distance entries (these two, ``int8_dist`` and ``ivf``'s
cluster distances) run one of two variants of ``csrc/dist_tile.cuh``,
which ``_plan`` picks from the row width and the operands' alignment:
``tile`` (persistent blocks over 64 x 128 output tiles, 8 x 8 outputs a
thread, operands staged by 16-byte copies) where every query and gallery
row and both bases are 16-byte aligned, else ``ragged`` (64 x 64 tiles,
4 x 4 outputs a thread, scalar staging). Both sum every output in the
same order, so they agree bit for bit. The tile variant ran faster at
every path shape, the cluster distances' 16 tiles included (chip_smoke
times both).

Take CUDA tensors only; ``ops.batched_pairwise_dist`` and
``ops.pairwise_dist`` send CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

VARIANTS = ("tile", "ragged")                # the .cu's Variant codes
# bytes of one gallery value in each mode of dist_tile.cuh: fp32 rows
# (``fp32``, ``norms`` with given squared norms) or int8 codes
VALUE_BYTES = {"fp32": 4, "norms": 4, "int8": 1}


class Plan(NamedTuple):
    variant: str                             # one of VARIANTS


def _plan(C: int, B: int, G: int, F: int, mode: str,
          aligned: bool) -> Plan:
    """The variant for (C, B, F) queries against (C, G, F) gallery rows of
    ``mode`` (a key of ``VALUE_BYTES``); ``aligned``: the query and gallery
    bases are 16-byte aligned. The tile variant copies 16 bytes at
    a time, so it needs F % 4 == 0 (fp32) or F % 16 == 0 (int8 codes);
    ``aligned=False`` gives the ragged variant at any shape. C, B and G do
    not change the choice: the tile ran ahead of the ragged variant at
    every grid timed on the card, down to the cluster distances' 16
    tiles."""
    if aligned and F > 0 and F * VALUE_BYTES[mode] % 16 == 0:
        return Plan("tile")
    return Plan("ragged")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def _batched(q, g, plan: Plan):
    """Launch the batched entry under ``plan``: (C, Q, G) distances."""
    C, Q, D = q.shape
    G = g.shape[1]
    dev = q.device
    out = torch.empty((C, Q, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.kernel("pairwise_dist", "repro_batched_pairwise_dist", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), g.data_ptr(), out.data_ptr(), C, Q, G, D,
                VARIANTS.index(plan.variant), stream)
    _build.raise_on_error("batched_pairwise_dist", rc)
    return out


def batched_pairwise_dist(q, g):
    """(C, Q, D) x (C, G, D) fp32 -> (C, Q, G) fp32 squared distances."""
    if q.dim() != 3 or g.dim() != 3:
        raise ValueError(f"expected q (C, Q, D) and g (C, G, D), got "
                         f"{tuple(q.shape)} and {tuple(g.shape)}")
    C, Q, D = q.shape
    G = g.shape[1]
    dev = q.device
    _build.check_operand("q", q, torch.float32, (C, Q, D), dev)
    _build.check_operand("g", g, torch.float32, (C, G, D), dev)
    out = _batched(q, g, _plan(C, Q, G, D, "fp32", _aligned(q, g)))
    if out.numel():
        batched_pairwise_dist.launches += 1
    return out


batched_pairwise_dist.launches = 0


_ARGS_2D = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def _pairwise(q, g, plan: Plan):
    """Launch the 2-D entry under ``plan``: (Q, G) distances."""
    Q, D = q.shape
    G = g.shape[0]
    dev = q.device
    out = torch.empty((Q, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.kernel("pairwise_dist", "repro_pairwise_dist", _ARGS_2D)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), g.data_ptr(), out.data_ptr(), Q, G, D,
                VARIANTS.index(plan.variant), stream)
    _build.raise_on_error("pairwise_dist", rc)
    return out


def pairwise_dist(q, g):
    """(Q, D) x (G, D) fp32 -> (Q, G) fp32 squared distances."""
    if q.dim() != 2 or g.dim() != 2:
        raise ValueError(f"expected q (Q, D) and g (G, D), got "
                         f"{tuple(q.shape)} and {tuple(g.shape)}")
    Q, D = q.shape
    G = g.shape[0]
    dev = q.device
    _build.check_operand("q", q, torch.float32, (Q, D), dev)
    _build.check_operand("g", g, torch.float32, (G, D), dev)
    out = _pairwise(q, g, _plan(1, Q, G, D, "fp32", _aligned(q, g)))
    if out.numel():
        pairwise_dist.launches += 1
    return out


pairwise_dist.launches = 0
