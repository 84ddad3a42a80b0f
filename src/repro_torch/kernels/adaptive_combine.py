"""CUDA kernel wrappers: FedSTIL's adaptive combine, Eq. 2
(``csrc/adaptive_combine.cu``; replace
``repro/kernels/adaptive_combine.py:adaptive_combine`` and its leaf-wise
``adaptive_combine_tree``).

    theta = B * alpha + A          (elementwise, any shape, fp32 or bf16)

``adaptive_combine_tree`` combines every leaf of a tree in one launch per
dtype group (``_plan`` lays the launches out); ``adaptive_combine`` is a
tree of one leaf. The product and the sum round
separately (in bf16: each computed in fp32 and rounded to bf16, as eager
PyTorch does), as in the plain version: the kernel is bit-identical to it.
Take CUDA tensors only; ``ops.adaptive_combine_tree`` and
``ops.adaptive_combine`` send CPU tensors to the plain version.
"""
from __future__ import annotations

import array
import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_void_p)
# the .cu's constants: leaves a launch (its table stays under 4 KB), threads
# a block, 16-byte vectors of each operand a thread
MAX_LEAVES = 64
THREADS, UNROLL = 256, 4
SPAN = {dt: THREADS * UNROLL * (16 // dt.itemsize)   # values a block covers
        for dt in (torch.float32, torch.bfloat16)}


class Launch(NamedTuple):
    dtype: torch.dtype
    leaves: Tuple[Tuple[int, int, bool], ...]  # (leaf index, first block, vec)
    blocks: int


def _plan(leaves: Sequence[Tuple[torch.dtype, int, Sequence[int]]]
          ) -> List[Launch]:
    """Lay out the launches for ``leaves``, each (dtype, length, the
    addresses of base, alpha, a and out): one launch per dtype group, in
    the order the groups first appear, split every ``MAX_LEAVES`` leaves;
    each leaf's first block (``SPAN[dtype]`` values a block) and its vector
    flag (all four addresses 16-byte aligned). Empty leaves get no block.
    Raises for a dtype the kernel lacks or a leaf of 2^31 values or more."""
    groups = {}
    for i, (dtype, n, (b, al, a, o)) in enumerate(leaves):
        if dtype not in SPAN:
            raise TypeError(f"adaptive_combine_tree: leaf {i} has dtype "
                            f"{dtype}, the kernel takes float32 or bfloat16")
        if n >= 1 << 31:
            raise ValueError(f"adaptive_combine_tree: leaf {i} has {n} "
                             "elements, the kernel indexes fewer than 2^31")
        if n:
            groups.setdefault(dtype, []).append(
                (i, n, not (b | al | a | o) & 15))
    out = []
    for dtype, members in groups.items():
        span = SPAN[dtype]
        for k in range(0, len(members), MAX_LEAVES):
            first, rows = 0, []
            for i, n, vec in members[k:k + MAX_LEAVES]:
                rows.append((i, first, vec))
                first += -(-n // span)
            out.append(Launch(dtype, tuple(rows), first))
    return out


def _leaf_ok(b, al, a, dev) -> bool:
    """All three tensors of the leaf on ``dev`` (a CUDA device), of one
    shape and a dtype the kernel takes, contiguous (checked inline: this
    runs for every leaf of every combine)."""
    if not (isinstance(b, torch.Tensor) and isinstance(al, torch.Tensor)
            and isinstance(a, torch.Tensor)):
        return False
    dtype, shape = b.dtype, b.shape
    return (b.is_cuda and b.device == dev and dtype in SPAN
            and al.device == dev and a.device == dev
            and al.dtype == dtype and a.dtype == dtype
            and al.shape == shape and a.shape == shape
            and b.is_contiguous() and al.is_contiguous()
            and a.is_contiguous())


def _check_leaf(i, b, al, a, dev) -> None:
    """Raise the reason ``_leaf_ok`` refused leaf ``i``."""
    if isinstance(b, torch.Tensor) and b.dtype not in SPAN:
        raise TypeError(f"adaptive_combine_tree: leaf {i} has dtype "
                        f"{b.dtype}, the kernel takes float32 or bfloat16")
    for name, t in ((f"base[{i}]", b), (f"alpha[{i}]", al), (f"a[{i}]", a)):
        _build.check_operand(name, t, getattr(b, "dtype", None),
                             tuple(getattr(b, "shape", ())), dev)


def adaptive_combine_tree(bases, alphas, as_) -> List[torch.Tensor]:
    """Flat lists of leaves -> [base * alpha + a] in each leaf's dtype, each
    output its own tensor; the three tensors of a leaf share its shape and
    dtype (float32 or bfloat16), every leaf lies on one CUDA device."""
    if not len(bases) == len(alphas) == len(as_):
        raise ValueError(f"adaptive_combine_tree: {len(bases)} bases, "
                         f"{len(alphas)} alphas, {len(as_)} residuals")
    if not bases:
        return []
    if not isinstance(bases[0], torch.Tensor):
        raise TypeError("adaptive_combine_tree: base[0] is a "
                        f"{type(bases[0]).__name__}, not a tensor")
    dev = bases[0].device
    for i, leaf in enumerate(zip(bases, alphas, as_)):
        if not _leaf_ok(*leaf, dev):
            _check_leaf(i, *leaf, dev)
    outs = [torch.empty_like(b) for b in bases]         # contiguous: b is
    ns = [b.numel() for b in bases]
    ptrs = [(b.data_ptr(), al.data_ptr(), a.data_ptr(), o.data_ptr())
            for b, al, a, o in zip(bases, alphas, as_, outs)]
    plan = _plan([(b.dtype, n, p) for b, n, p in zip(bases, ns, ptrs)])
    if not plan:
        return outs
    fn = _build.kernel("adaptive_combine", "repro_adaptive_combine_tree",
                       _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in plan:
            flat = []                  # seven int64 a leaf, as the .cu reads
            for i, first, vec in launch.leaves:
                flat.extend(ptrs[i])
                flat.extend((ns[i], first, vec))
            desc = array.array("q", flat)
            rc = fn(desc.buffer_info()[0], len(launch.leaves),
                    int(launch.dtype == torch.bfloat16), launch.blocks,
                    stream)
            _build.raise_on_error("adaptive_combine_tree", rc)
            adaptive_combine_tree.launches += 1
    return outs


adaptive_combine_tree.launches = 0


def adaptive_combine(base, alpha, a):
    """Three fp32 (or three bf16) tensors of one shape -> base * alpha + a
    in their dtype: ``adaptive_combine_tree`` over this one leaf, its
    launch counted in both counts."""
    before = adaptive_combine_tree.launches
    (out,) = adaptive_combine_tree([base], [alpha], [a])
    adaptive_combine.launches += adaptive_combine_tree.launches - before
    return out


adaptive_combine.launches = 0
