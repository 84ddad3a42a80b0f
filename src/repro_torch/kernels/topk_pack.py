"""CUDA kernel wrappers of the wire codec's grouped top-k and index
bit-packing (``csrc/topk_pack.cu``; replace
``repro/kernels/topk_pack.py:batched_topk_pack``, ``:batched_topk_unpack``,
``:batched_idx_bitpack`` and ``:batched_idx_bitunpack``, and with them
``repro/kernels/quantize.py:batched_dequantize`` on the int8 codec's path).

The codec's path takes two launches, each folding two of the four (the
int8 decode also the dequantize):

    encode:     (C, P) fp32 -> (values (C, nb*kg) fp32, bit-planes (C,
                bits*ceil(nb*kg/8)) uint8): pack, then bit-pack, with no
                int32 index tensor in between
    decode:     values + bit-planes -> dense (C, p) fp32: bit-unpack, then
                unpack
    decode_int8:
                int8 codes (C, nb*kg) + chunk scales (C, ceil(nb*kg/chunk))
                fp32 + bit-planes -> dense (C, p) fp32: dequantize, then
                decode, with no fp32 value tensor in between; the decode's
                kernel with another prologue

Each block of all three owns THREADS * per consecutive groups of one row
(``_plan``). The four one-stage kernels below stay, as the counterparts
of the reference's four functions:

    pack:       (C, P) fp32 -> the kg largest magnitudes of every group of
                ``group`` contiguous elements, in rank order (ties to the
                lowest index): values (C, nb*kg) fp32, absolute indices
                (C, nb*kg) int32, nb = ceil(P / group)
    unpack:     values + indices -> dense (C, p) fp32
    bitpack:    (C, K) int32 indices -> (C, bits*ceil(K/8)) uint8 planes of
                the local in-group index, bits = (group-1).bit_length()
    bitunpack:  (C, bits*kb) uint8 -> (C, k) int32 absolute indices

The pack and unpack kernels take 1 <= kg <= group <= 16, encode and
the decodes 2 <= group <= 16 (a plane needs a bit) and at most ``MAX_ROWS``
rows (the grid's second dimension); every kernel indexes its threads and
slots in 32 bits, so a call needs fewer than 2^31 of them. Take CUDA
tensors only; the ``ops`` dispatchers send CPU tensors to the plain
versions.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

MAX_GROUP = 16
MAX_THREADS = 1 << 31
MAX_ROWS = 65535            # encode / decode: a grid row a payload row
THREADS = 256               # encode / decode: threads a block (csrc kThreads)
PER_THREAD = (1, 2)         # encode / decode: groups a thread, by variant
# the largest per-1 grid (blocks) that takes per 1: up to two blocks an SM
# of a 132-SM H100, where more blocks of less work finish sooner (a launch-
# bound call); past it, two groups a thread keep twice the bytes in flight
SMALL_GRID = 264
_PACK_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 2
              + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
_UNPACK_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 2
                + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
_BITPACK_ARGS = ((ctypes.c_void_p,) * 2 + (ctypes.c_longlong,) * 2
                 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
_BITUNPACK_ARGS = ((ctypes.c_void_p,) * 2 + (ctypes.c_longlong,) * 3
                   + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_ENCODE_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 2
                + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_DECODE_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) * 3
                + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_DECODE_INT8_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) * 4
                     + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


def _check_budget(group: int, kg: int) -> None:
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"group {group}: the CUDA kernels take 1..{MAX_GROUP}")
    if not 1 <= kg <= group:
        raise ValueError(f"kg {kg}: must lie in 1..group ({group})")


def _check_size(n: int, what: str) -> None:
    if n >= MAX_THREADS:
        raise ValueError(f"{what}: {n} elements, the kernel indexes fewer "
                         f"than 2^31")


def _bits(group: int) -> int:
    if group < 2:
        raise ValueError(f"group {group}: bit-packing needs group >= 2")
    return (group - 1).bit_length()


def _launch(source_symbol, argtypes, what, dev, *args):
    fn = _build.kernel("topk_pack", source_symbol, argtypes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    _build.raise_on_error(what, rc)


def batched_topk_pack(x, *, group: int = 8, kg: int):
    """(C, P) fp32 -> (values (C, nb*kg) fp32, indices (C, nb*kg) int32)."""
    if x.dim() != 2:
        raise ValueError(f"x: expected (C, P), got shape {tuple(x.shape)}")
    _check_budget(group, kg)
    C, P = x.shape
    dev = x.device
    _build.check_operand("x", x, torch.float32, (C, P), dev)
    K = (P + group - 1) // group * kg
    _check_size(max(C * K, P), "batched_topk_pack")
    vals = torch.empty((C, K), dtype=torch.float32, device=dev)
    idx = torch.empty((C, K), dtype=torch.int32, device=dev)
    if C * K == 0:
        return vals, idx
    vec = int(P % 4 == 0 and x.data_ptr() % 16 == 0)
    _launch("repro_batched_topk_pack", _PACK_ARGS, "batched_topk_pack", dev,
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), C, P, group, kg,
            vec)
    batched_topk_pack.launches += 1
    return vals, idx


batched_topk_pack.launches = 0


def batched_topk_unpack(vals, idx, *, p: int, group: int = 8, kg: int):
    """Values + absolute indices (C, ceil(p/group)*kg) -> dense (C, p)
    fp32; a local index outside 0..group-1 adds nothing, duplicates sum."""
    if vals.dim() != 2:
        raise ValueError(f"vals: expected (C, K), got {tuple(vals.shape)}")
    _check_budget(group, kg)
    C, K = vals.shape
    if K != (p + group - 1) // group * kg:
        raise ValueError(f"vals: {K} slots, p={p} needs "
                         f"{(p + group - 1) // group * kg}")
    dev = vals.device
    _build.check_operand("vals", vals, torch.float32, (C, K), dev)
    _build.check_operand("idx", idx, torch.int32, (C, K), dev)
    _check_size(C * ((p + group - 1) // group) * group, "batched_topk_unpack")
    out = torch.empty((C, p), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    vec = int(p % 4 == 0 and out.data_ptr() % 16 == 0)
    _launch("repro_batched_topk_unpack", _UNPACK_ARGS, "batched_topk_unpack",
            dev, vals.data_ptr(), idx.data_ptr(), out.data_ptr(), C, p, group,
            kg, vec)
    batched_topk_unpack.launches += 1
    return out


batched_topk_unpack.launches = 0


def batched_idx_bitpack(idx, *, group: int = 8, kg: int):
    """(C, K) int32 absolute indices -> (C, bits*ceil(K/8)) uint8."""
    if idx.dim() != 2:
        raise ValueError(f"idx: expected (C, K), got {tuple(idx.shape)}")
    if kg < 1:
        raise ValueError(f"kg must be positive, got {kg}")
    bits = _bits(group)
    C, K = idx.shape
    dev = idx.device
    _build.check_operand("idx", idx, torch.int32, (C, K), dev)
    kb = (K + 7) // 8
    _check_size(C * kb * 8, "batched_idx_bitpack")
    out = torch.empty((C, bits * kb), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    _launch("repro_batched_idx_bitpack", _BITPACK_ARGS, "batched_idx_bitpack",
            dev, idx.data_ptr(), out.data_ptr(), C, K, group, kg, bits)
    batched_idx_bitpack.launches += 1
    return out


batched_idx_bitpack.launches = 0


def batched_idx_bitunpack(packed, *, k: int, group: int = 8, kg: int):
    """(C, bits*kb) uint8 bit-planes -> (C, k) int32 absolute indices."""
    if packed.dim() != 2:
        raise ValueError(f"packed: expected (C, bits*kb), got "
                         f"{tuple(packed.shape)}")
    if kg < 1:
        raise ValueError(f"kg must be positive, got {kg}")
    bits = _bits(group)
    C, nbytes = packed.shape
    if nbytes % bits or k > nbytes // bits * 8:
        raise ValueError(f"packed: {nbytes} bytes a row do not hold {bits} "
                         f"planes of {k} slots")
    kb = nbytes // bits
    dev = packed.device
    _build.check_operand("packed", packed, torch.uint8, (C, nbytes), dev)
    _check_size(C * kb * 8, "batched_idx_bitunpack")
    out = torch.empty((C, k), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    vec = int(k % 4 == 0 and out.data_ptr() % 16 == 0)
    _launch("repro_batched_idx_bitunpack", _BITUNPACK_ARGS,
            "batched_idx_bitunpack", dev, packed.data_ptr(), out.data_ptr(),
            C, k, kb, group, kg, bits, vec)
    batched_idx_bitunpack.launches += 1
    return out


batched_idx_bitunpack.launches = 0


@dataclass(frozen=True)
class Plan:
    """The launch geometry of encode and decode on (rows, ceil(p/group))
    groups: block (x, c) owns ``groups`` = THREADS * per consecutive groups
    of row c from x * groups on, thread t of it groups t, t + THREADS, ...;
    its slots start at x * groups * kg, a multiple of 8, on byte x * groups
    * kg / 8 of every plane. ``vec``: the dense rows keep 16-byte accesses
    aligned (group a multiple of 4, p % 4 == 0, an aligned base)."""
    rows: int
    nb: int
    kg: int
    per: int
    vec: bool

    @property
    def groups(self) -> int:
        return THREADS * self.per

    @property
    def grid(self):
        return (-(-self.nb // self.groups), self.rows)

    def slots(self, x: int) -> range:
        """The row's slots block x owns."""
        return range(x * self.groups * self.kg,
                     min((x + 1) * self.groups, self.nb) * self.kg)

    def plane_bytes(self, x: int) -> range:
        """The bytes of each plane block x writes (encode) or reads."""
        s = self.slots(x)
        return range(s.start // 8, -(-s.stop // 8))


def _plan(rows: int, p: int, group: int, kg: int, aligned: bool,
          per: int = None) -> Plan:
    """The geometry of a launch on (rows, p) payload rows; ``per`` forces
    the variant (groups a thread), else the grid's size picks it."""
    nb = -(-p // group)
    if per is None:
        per = 1 if rows * -(-nb // THREADS) <= SMALL_GRID else 2
    return Plan(rows=rows, nb=nb, kg=kg, per=per,
                vec=group % 4 == 0 and p % 4 == 0 and aligned)


def _check_codec(rows: int, group: int, kg: int) -> int:
    _check_budget(group, kg)
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows: encode and decode take at most "
                         f"{MAX_ROWS}")
    return _bits(group)


def _encode(x, vals, planes, group, kg, plan):
    """One encode launch under ``plan``, uncounted (checked operands)."""
    C, P = x.shape
    _launch("repro_batched_topk_encode", _ENCODE_ARGS, "batched_topk_encode",
            x.device, x.data_ptr(), vals.data_ptr(), planes.data_ptr(), C, P,
            group, kg, int(plan.vec), plan.per)


def _decode(vals, packed, out, group, kg, plan):
    """One decode launch under ``plan``, uncounted (checked operands)."""
    C, p = out.shape
    _launch("repro_batched_topk_decode", _DECODE_ARGS, "batched_topk_decode",
            out.device, vals.data_ptr(), packed.data_ptr(), out.data_ptr(), C,
            p, packed.shape[1] // _bits(group), group, kg, int(plan.vec),
            plan.per)


def _decode_int8(codes, scales, packed, out, group, kg, chunk, plan):
    """One int8 decode launch under ``plan``, uncounted (checked
    operands)."""
    C, p = out.shape
    _launch("repro_batched_topk_decode_int8", _DECODE_INT8_ARGS,
            "batched_topk_decode_int8", out.device, codes.data_ptr(),
            scales.data_ptr(), packed.data_ptr(), out.data_ptr(), C, p,
            packed.shape[1] // _bits(group), scales.shape[1], chunk, group,
            kg, int(plan.vec), plan.per)


def batched_topk_encode(x, *, group: int = 8, kg: int):
    """(C, P) fp32 -> (values (C, nb*kg) fp32, bit-planes (C, bits *
    ceil(nb*kg/8)) uint8): ``batched_topk_pack`` then
    ``batched_idx_bitpack``, in one launch."""
    if x.dim() != 2:
        raise ValueError(f"x: expected (C, P), got shape {tuple(x.shape)}")
    C, P = x.shape
    bits = _check_codec(C, group, kg)
    dev = x.device
    _build.check_operand("x", x, torch.float32, (C, P), dev)
    K = (P + group - 1) // group * kg
    _check_size(max(C * K, P), "batched_topk_encode")
    kb = (K + 7) // 8
    vals = torch.empty((C, K), dtype=torch.float32, device=dev)
    planes = torch.empty((C, bits * kb), dtype=torch.uint8, device=dev)
    if C * K == 0:
        return vals, planes
    _encode(x, vals, planes, group, kg,
            _plan(C, P, group, kg, x.data_ptr() % 16 == 0))
    batched_topk_encode.launches += 1
    return vals, planes


batched_topk_encode.launches = 0


def _check_decode(name, vals, packed, k, p, group, kg, what):
    """The shape checks both decodes share; returns (C, K, bytes a plane
    row)."""
    if vals.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"{name}, packed: expected (C, k) and (C, bits*kb), "
                         f"got {tuple(vals.shape)}, {tuple(packed.shape)}")
    C, K = vals.shape
    bits = _check_codec(C, group, kg)
    if K != k or K != (p + group - 1) // group * kg:
        raise ValueError(f"{name}: {K} slots, k={k}, p={p} needs "
                         f"{(p + group - 1) // group * kg}")
    nbytes = packed.shape[1]
    if nbytes % bits or k > nbytes // bits * 8:
        raise ValueError(f"packed: {nbytes} bytes a row do not hold {bits} "
                         f"planes of {k} slots")
    _check_size(C * ((p + group - 1) // group) * group, what)
    return C, K, nbytes


def batched_topk_decode(vals, packed, *, k: int, p: int, group: int = 8,
                        kg: int):
    """Values (C, k) + bit-planes (C, bits*kb) -> dense (C, p) fp32:
    ``batched_idx_bitunpack`` then ``batched_topk_unpack``, in one launch;
    k = ceil(p/group)*kg <= 8*kb."""
    C, K, nbytes = _check_decode("vals", vals, packed, k, p, group, kg,
                                 "batched_topk_decode")
    dev = vals.device
    _build.check_operand("vals", vals, torch.float32, (C, K), dev)
    _build.check_operand("packed", packed, torch.uint8, (C, nbytes), dev)
    out = torch.empty((C, p), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _decode(vals, packed, out, group, kg,
            _plan(C, p, group, kg, out.data_ptr() % 16 == 0))
    batched_topk_decode.launches += 1
    return out


batched_topk_decode.launches = 0


def batched_topk_decode_int8(codes, scales, packed, *, k: int, p: int,
                             group: int = 8, kg: int, chunk: int = 256):
    """int8 codes (C, k) + chunk scales (C, ceil(k/chunk)) fp32 +
    bit-planes (C, bits*kb) -> dense (C, p) fp32: the quantizer's
    ``batched_dequantize`` then ``batched_topk_decode``, in one launch, bit
    for bit (value = code * scale, one IEEE product)."""
    C, K, nbytes = _check_decode("codes", codes, packed, k, p, group, kg,
                                 "batched_topk_decode_int8")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    nc = -(-K // chunk)
    if tuple(scales.shape) != (C, nc):
        raise ValueError(f"scales: shape {tuple(scales.shape)}, {K} slots in "
                         f"chunks of {chunk} need ({C}, {nc})")
    dev = codes.device
    _build.check_operand("codes", codes, torch.int8, (C, K), dev)
    _build.check_operand("scales", scales, torch.float32, (C, nc), dev)
    _build.check_operand("packed", packed, torch.uint8, (C, nbytes), dev)
    out = torch.empty((C, p), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _decode_int8(codes, scales, packed, out, group, kg, chunk,
                 _plan(C, p, group, kg, out.data_ptr() % 16 == 0))
    batched_topk_decode_int8.launches += 1
    return out


batched_topk_decode_int8.launches = 0
