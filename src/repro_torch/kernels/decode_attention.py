"""CUDA kernel wrapper: one decode token's attention against the KV cache
(``csrc/decode_attention.cu``), flash-decoding over the cache's valid slots
[lo, hi) of this rank, read in place in its own dtype (bf16 or fp32).

Replaces no TPU kernel: the JAX package decodes with jnp einsums, which the
port ran as two einsums over a whole-cache fp32 copy (``decode_attention_ref``
below is that arithmetic over the same range). The kernel is bound by the
cache's bytes on the H100; the source's note gives its design.

``_plan`` picks the q heads a block takes (1, 2 or 4), the lanes a slot (8
up to hd 64, 16 up to hd 128) and the split of [lo, hi): enough splits that
the grid fills every SM ``BLOCKS_PER_SM`` blocks over at the shape's B x KV,
none shorter than ``MIN_CHUNK`` slots. One split is one launch (the block
writes the output); more are two (the splits' partials, then their merge).
``launches`` counts the kernel launches.

Takes CUDA tensors only; ``ops.decode_attention`` sends CPU and meta tensors
to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

THREADS = 256               # the split kernel's block (csrc kThreads)
MIN_CHUNK = 256             # slots: no split shorter
BLOCKS_PER_SM = 32          # the split count's aim at the shape's B x KV
MAX_SPLITS = 4096           # the merge's weights in shared memory
MAX_HD = 128
MAX_GRID_Z = 65535          # the split grid's B x nsplit
EMPTY = -1e30               # m of a rank that saw no slot

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q k v o m l, B KV R hd, strides, lo hi nsplit chunk, scale, normalize,
# bf16, stream
_SPLIT = ((_P,) * 6 + (_I,) * 4 + (_L,) * 4 + (_I,) * 4
          + (ctypes.c_float, _I, _I, _P))
# partials o m l, outputs o m l, rows R hd nsplit normalize, stream
_MERGE = (_P,) * 6 + (_I,) * 5 + (_P,)
_DTYPES = (torch.bfloat16, torch.float32)


class Plan(NamedTuple):
    heads: int                  # q heads a block takes (the source's RT)
    lanes: int                  # lanes sharing a slot (GP)
    nsplit: int                 # splits of [lo, hi)
    chunk: int                  # slots a split, a multiple of a block's pass


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(B: int, KV: int, R: int, hd: int, length: int, itemsize: int,
          sms: int, blocks_per_sm: int = BLOCKS_PER_SM) -> Plan:
    """The launch for q (B, KV, R, hd) against ``length`` valid slots of
    an ``itemsize``-byte cache on a card of ``sms`` SMs; ``blocks_per_sm``
    forces another split count (chip_smoke's sweep)."""
    heads = R if R <= 2 else 4
    lanes = 8 if hd <= 64 else 16
    unroll = 2 if heads == 4 or itemsize == 4 else 4
    step = THREADS // lanes * unroll         # slots a block takes a pass
    if length <= 0:
        return Plan(heads, lanes, 1, 0)
    rows = B * KV * _cdiv(R, heads)
    nsplit = max(1, min(_cdiv(blocks_per_sm * sms, rows),
                        _cdiv(length, MIN_CHUNK), MAX_SPLITS,
                        MAX_GRID_Z // B))
    chunk = _cdiv(_cdiv(length, nsplit), step) * step
    return Plan(heads, lanes, _cdiv(length, chunk), chunk)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_ref(q, k, v, lo: int, hi: int, *,
                         partial: bool = False):
    """The plain version: q (B, KV, R, hd) against k and v (B, S, KV, hd)
    at slots [lo, hi), in fp32 (q scaled by 1/sqrt(hd), the cache upcast).
    -> o (B, KV, R, hd) fp32, normalized; with ``partial``, (o unnormalized,
    m, l) for a merge across ranks, an empty range giving (0, -1e30, 0)."""
    _check_range(q, k, lo, hi, partial)
    hd = q.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bgrh,bkgh->bgrk", qf, k[:, lo:hi].float())
    m = (torch.amax(s, -1) if hi > lo
         else s.new_full(s.shape[:3], EMPTY))
    pr = torch.exp(s - m[..., None])
    l = torch.sum(pr, -1)
    o = torch.einsum("bgrk,bkgh->bgrh", pr, v[:, lo:hi].float())
    if partial:
        return o, m, l
    return o / torch.clamp(l, min=1e-30)[..., None]


def _check_range(q, k, lo: int, hi: int, partial: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or q.shape[0] != k.shape[0] \
            or q.shape[1] != k.shape[2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"decode attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: expected (B, KV, R, hd) and "
                         "(B, S, KV, hd)")
    if not 0 <= lo <= hi <= k.shape[1]:
        raise ValueError(f"decode attention: slots [{lo}, {hi}) outside "
                         f"the cache's {k.shape[1]}")
    if hi == lo and not partial:
        raise ValueError("decode attention: no valid slot (only a rank's "
                         "partial may be empty)")


def _aligned(t: torch.Tensor) -> bool:
    """16-byte loads at every slot: base and batch / slot strides on 16
    bytes, each kv head's hd values contiguous."""
    per = 16 // t.element_size()
    hd = t.shape[3]
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and (t.shape[2] == 1 or t.stride(2) == hd)
            and t.stride(0) % per == 0 and t.stride(1) % per == 0)


def decode_attention(q, k, v, lo: int, hi: int, *, partial: bool = False):
    """q (B, KV, R, hd) fp32 against k and v (B, S, KV, hd) in bf16 or fp32
    (any batch and slot strides) at slots [lo, hi) -> o (B, KV, R, hd) fp32,
    normalized; with ``partial``, (o unnormalized, m, l), each (B, KV, R)."""
    _check_range(q, k, lo, hi, partial)
    B, KV, R, hd = q.shape
    dev = q.device
    if q.dtype != torch.float32:
        raise TypeError(f"decode attention: q dtype {q.dtype}, the kernel "
                        "takes float32")
    if k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"decode attention: k {k.dtype}, v {v.dtype}: the "
                        "kernel takes bfloat16 or float32, both alike")
    if hd % 8 or not 8 <= hd <= MAX_HD or max(B, KV) > MAX_GRID_Z:
        raise ValueError(f"decode attention: hd {hd} (8 to {MAX_HD}, a "
                         f"multiple of 8), B {B} and KV {KV} (<= "
                         f"{MAX_GRID_Z})")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"decode attention: {name} on {t.device}, q on "
                             f"{dev}")
        if tuple(t.shape) != tuple(k.shape) or not _aligned(t):
            raise ValueError(f"decode attention: {name} {tuple(t.shape)} "
                             f"strides {t.stride()}: needs k's shape, a "
                             "16-byte base and strides, contiguous heads")
    if k.shape[1] >= 1 << 31:
        raise ValueError("decode attention: 2^31 slots or more")
    plan = _plan(B, KV, R, hd, hi - lo, k.element_size(), _sms(dev.index))
    out = _launch(q.contiguous(), k, v, lo, hi, partial, plan)
    decode_attention.launches += 1 if plan.nsplit == 1 else 2
    return out


def _launch(q, k, v, lo: int, hi: int, partial: bool, plan: Plan):
    """Launch under ``plan`` (checked operands; chip_smoke's sweep forces
    plans): one launch for one split, two for more. Counts nothing."""
    B, KV, R, hd = q.shape
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.empty((B, KV, R, hd), **f32)
    m = l = None
    if partial:
        m, l = torch.empty((B, KV, R), **f32), torch.empty((B, KV, R), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    split = _build.kernel("decode_attention", "repro_decode_attention",
                          _SPLIT)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        common = (B, KV, R, hd, k.stride(0), k.stride(1), v.stride(0),
                  v.stride(1), lo, hi, plan.nsplit, plan.chunk,
                  ctypes.c_float(1.0 / math.sqrt(hd)))
        bf16 = int(k.dtype == torch.bfloat16)
        if plan.nsplit == 1:
            rc = split(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), ptr(m), ptr(l), *common,
                       int(not partial), bf16, stream)
            _build.raise_on_error("decode_attention", rc)
        else:
            op = torch.empty((B * KV, plan.nsplit, R, hd), **f32)
            mp = torch.empty((B * KV, plan.nsplit, R), **f32)
            lp = torch.empty_like(mp)
            rc = split(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       op.data_ptr(), mp.data_ptr(), lp.data_ptr(), *common,
                       0, bf16, stream)
            _build.raise_on_error("decode_attention", rc)
            merge = _build.kernel("decode_attention",
                                  "repro_decode_attention_merge", _MERGE)
            rc = merge(op.data_ptr(), mp.data_ptr(), lp.data_ptr(),
                       o.data_ptr(), ptr(m), ptr(l), B * KV * R, R, hd,
                       plan.nsplit, int(not partial), stream)
            _build.raise_on_error("decode_attention merge", rc)
    return (o, m, l) if partial else o


decode_attention.launches = 0
