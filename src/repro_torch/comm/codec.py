"""Wire-format codec stack: the payloads the comm accounting measures.

A numpy copy of ``repro/comm/codec.py``. ``Codec.encode(tree) ->
WirePayload`` materializes the exact buffers a client or server would put
on the wire; ``decode(WirePayload) -> tree`` reconstructs the (possibly
lossy) payload the receiver trains on. Stages compose in a fixed order
over the flattened fp32 payload vector:

    delta  — residual against the last reconstruction this peer shipped
             (stateful per ``peer``; the encoder tracks the DECODER-visible
             reconstruction, so both sides stay in sync under lossy stages
             and dropped coordinates re-enter the next residual: error
             feedback. On by default with topk, see ``make_codec``. A
             stream's first payload is a dense keyframe that establishes
             the reference; every later payload is a sparse residual);
    topk   — top-k magnitude sparsification -> (values, indices), ties by
             lowest index. GROUPED by default (the kg largest of every
             group of 8 contiguous elements, the budget the CUDA kernels
             implement, see ``kernels/topk_pack.py``), whose indices ship
             BIT-PACKED (3 bits a slot at group 8); an explicit ``k``
             selects exact global top-k (host only, plain int32 indices,
             what FedWeIT's sparse-bytes formula models);
    int8 | bf16 — value quantization: per-chunk symmetric int8 with one
             fp32 scale per ``chunk`` values (``quantize_host``, a true
             division by 127 as the reference's numpy writes it), or
             bfloat16 (round to nearest even). The bf16 buffer holds the
             bfloat16 bit patterns as uint16 (``bf16_bits_host``): the same
             bits and ``nbytes`` as the reference's ml_dtypes array, without
             ml_dtypes.

Trees are nested dicts of tensors or arrays, flattened in the port's leaf
order (``common.pytree``), which is ``jax.tree.flatten``'s; leaves come
back as numpy arrays. The stacked engine runs the same stages over all C
clients at once on the device (``comm.batched.BatchedCodec``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import leaf_paths, tree_from_paths, tree_leaves

DEFAULT_KEEP_FRAC = 0.35
DEFAULT_CHUNK = 256
DEFAULT_GROUP = 8

_STAGES = ("raw", "delta", "topk", "int8", "bf16")


@dataclasses.dataclass
class WirePayload:
    """One encoded payload: named wire buffers + the schema to decode them.

    ``nbytes`` counts the buffers only: the schema (tree structure, sizes)
    is per-connection setup traffic, not per-round payload."""

    buffers: Dict[str, np.ndarray]
    schema: Dict[str, Any]

    @property
    def nbytes(self) -> int:
        return int(sum(b.nbytes for b in self.buffers.values()))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_host(tree) -> Tuple[np.ndarray, tuple]:
    """Tree -> (fp32 vector, meta), in ``common.pytree`` leaf order."""
    arrs = [_host(leaf) for leaf in tree_leaves(tree)]
    meta = (leaf_paths(tree), [a.shape for a in arrs], [a.dtype for a in arrs])
    if not arrs:
        return np.zeros((0,), np.float32), meta
    return np.concatenate([a.ravel().astype(np.float32) for a in arrs]), meta


def _unflatten_host(flat: np.ndarray, meta) -> Any:
    paths, shapes, dtypes = meta
    leaves, off = [], 0
    for s, dt in zip(shapes, dtypes):
        n = int(np.prod(s)) if len(s) else 1
        leaves.append(flat[off:off + n].reshape(s).astype(dt))
        off += n
    return tree_from_paths(paths, leaves)


def topk_select_host(x: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact GLOBAL top-k by magnitude over a host vector: (values fp32,
    indices int32), ascending index order, ties at the k-th magnitude kept
    by lowest index."""
    k = min(k, x.size)
    if k == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int32)
    absx = np.abs(x)
    thr = np.partition(absx, x.size - k)[x.size - k]
    keep = absx > thr
    n_above = int(keep.sum())
    if n_above < k:
        ties = np.flatnonzero(absx == thr)[:k - n_above]
        keep[ties] = True
    idx = np.flatnonzero(keep).astype(np.int32)
    return x[idx].astype(np.float32), idx


def grouped_topk_select_host(x: np.ndarray, group: int,
                             kg: int) -> Tuple[np.ndarray, np.ndarray]:
    """Grouped top-k over a host vector: every group of ``group``
    contiguous elements keeps its ``kg`` largest magnitudes (ties by
    lowest index), packed in magnitude-rank order. The counting formulas
    of ``kernels.ref.batched_topk_pack_ref`` and the CUDA pack kernel."""
    P = x.size
    nb = (P + group - 1) // group
    xp = np.zeros((nb * group,), np.float32)
    xp[:P] = x
    xg = xp.reshape(nb, group)
    a = np.abs(xg)
    ii = np.arange(group)
    beats = (a[:, None, :] > a[:, :, None]) | (
        (a[:, None, :] == a[:, :, None]) & (ii[None, :] < ii[:, None]))
    rank = beats.sum(-1)                                   # (nb, G)
    onehot = rank[..., None] == np.arange(kg)              # (nb, G, kg)
    vals = np.sum(xg[..., None] * onehot, axis=1, dtype=np.float32)
    gidx = (np.arange(nb)[:, None] * group + ii[None, :])
    idx = np.sum(gidx[..., None] * onehot, axis=1).astype(np.int32)
    return vals.reshape(-1), idx.reshape(-1)


def pack_group_indices_host(idx: np.ndarray, group: int,
                            kg: int) -> np.ndarray:
    """Bit-pack grouped top-k indices for the wire: (K,) int32 absolute
    indices (slot s in group s // kg) -> (bits * ceil(K/8),) uint8, bits =
    (group-1).bit_length(). Bit-plane-major, the layout of
    ``kernels.ref.batched_idx_bitpack_ref`` and the CUDA kernel."""
    bits = (group - 1).bit_length()
    K = idx.size
    kb = (K + 7) // 8
    li = idx.astype(np.int32) - (np.arange(K, dtype=np.int32) // kg) * group
    lip = np.zeros((kb * 8,), np.int32)
    lip[:K] = li
    lib = lip.reshape(kb, 8)
    lane = (1 << np.arange(8)).astype(np.int32)
    planes = [(((lib >> j) & 1) * lane).sum(1) for j in range(bits)]
    return np.concatenate(planes).astype(np.uint8)


def unpack_group_indices_host(packed: np.ndarray, k: int, group: int,
                              kg: int) -> np.ndarray:
    """Inverse of ``pack_group_indices_host``: uint8 bit-planes -> (k,)
    int32 absolute indices."""
    bits = (group - 1).bit_length()
    kb = packed.size // bits
    b = packed.reshape(bits, kb).astype(np.int32)
    flat = ((b[:, :, None] >> np.arange(8)) & 1).reshape(bits, kb * 8)[:, :k]
    li = np.zeros((k,), np.int32)
    for j in range(bits):
        li += flat[j] << j
    return (np.arange(k, dtype=np.int32) // kg) * group + li


def quantize_host(v: np.ndarray, chunk: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-chunk symmetric int8: (n,) fp32 -> ((n,) int8, per-chunk fp32
    scales), round half to even. The scale is ``absmax / 127`` divided in
    numpy, as in the reference's host codec (the batched codec multiplies by
    fl32(1/127) instead, as the reference's compiled kernel does: a scale
    can differ by an ulp between the two, ROADMAP Queue 3)."""
    n = v.size
    nc = (n + chunk - 1) // chunk          # 0 chunks for an empty payload
    vp = np.zeros((nc * chunk,), np.float32)
    vp[:n] = v
    vc = vp.reshape(nc, chunk)
    absmax = np.max(np.abs(vc), axis=1, keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    scale = np.where(scale > 0, scale, np.float32(1.0))   # 0 / subnormal
    q = np.clip(np.rint(vc / scale), -127.0, 127.0).astype(np.int8)
    return q.reshape(-1)[:n], scale[:, 0]


def dequantize_host(q: np.ndarray, scales: np.ndarray,
                    chunk: int) -> np.ndarray:
    """Inverse of ``quantize_host``: int8 codes x per-chunk scales -> fp32."""
    n = q.size
    nc = scales.size
    qp = np.zeros((nc * chunk,), np.float32)
    qp[:n] = q.astype(np.float32)
    out = qp.reshape(nc, chunk) * scales[:, None]
    return out.reshape(-1)[:n]


def bf16_bits_host(v: np.ndarray) -> np.ndarray:
    """fp32 -> the bfloat16 bit patterns (uint16), rounded to nearest even
    as ml_dtypes' cast does; a NaN becomes the quiet NaN 0x7FC0 with its
    sign."""
    b = np.ascontiguousarray(v, np.float32).view(np.uint32)
    rounded = (b + np.uint32(0x7FFF) + ((b >> 16) & 1)) >> 16
    nan = (b & 0x7FFFFFFF) > 0x7F800000
    return np.where(nan, ((b >> 16) & 0x8000) | 0x7FC0,
                    rounded).astype(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Inverse of ``bf16_bits_host`` (exact: bf16 is fp32's top half)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


class Codec:
    """Interface: one bidirectional wire format."""

    spec: str = "raw"

    def encode(self, tree, peer=None) -> WirePayload:
        raise NotImplementedError

    def decode(self, payload: WirePayload, peer=None):
        raise NotImplementedError


class PipelineCodec(Codec):
    """The composable delta -> topk -> {int8|bf16} stack (any subset).

    ``keep_frac`` sizes the grouped budget as kg = round(keep_frac *
    group) kept entries per group (an explicit ``k`` switches to exact
    global top-k, FedWeIT's accounting). Stateful only when ``delta`` is
    on: per-``peer`` encoder and decoder references track the
    reconstruction each side has seen (first payload per peer = dense
    keyframe)."""

    def __init__(self, spec: str, *, delta: bool = False,
                 topk: bool = False, keep_frac: float = DEFAULT_KEEP_FRAC,
                 k: Optional[int] = None, group: Optional[int] = DEFAULT_GROUP,
                 quant: Optional[str] = None, chunk: int = DEFAULT_CHUNK):
        if quant not in (None, "int8", "bf16"):
            raise ValueError(f"unknown quant stage {quant!r}")
        self.spec = spec
        self.delta = delta
        self.topk = topk
        self.keep_frac = keep_frac
        self.k = k
        # explicit k selects exact GLOBAL top-k (host-only codec mode, the
        # FedWeIT formula check); otherwise the grouped budget applies
        self.group = None if k is not None else group
        self.kg = (max(1, int(round(keep_frac * group)))
                   if self.group else None)
        self.quant = quant
        self.chunk = chunk
        self._enc_ref: Dict[Any, np.ndarray] = {}
        self._dec_ref: Dict[Any, np.ndarray] = {}

    def k_for(self, p: int) -> int:
        """Total kept entries for a payload of p elements."""
        if self.group is not None:
            return ((p + self.group - 1) // self.group) * self.kg
        if self.k is not None:
            return min(self.k, p)
        return min(p, max(1, int(self.keep_frac * p)))

    # ---- encode --------------------------------------------------------------
    def encode(self, tree, peer=None) -> WirePayload:
        payload, ref = self._build(tree, peer)
        if self.delta:
            # advance the encoder ref by what the DECODER will reconstruct,
            # so lossy stages never let the two sides drift
            self._enc_ref[peer] = ref + self._decode_residual(payload)
        return payload

    def roundtrip(self, tree, peer=None):
        """encode + decode in one pass: (decoded tree, payload). Both
        references advance exactly as separate encode() / decode() calls
        would; the reconstruction is computed once."""
        payload, ref = self._build(tree, peer)
        recon = self._decode_residual(payload)
        if self.delta:
            recon = ref + recon
            self._enc_ref[peer] = recon
            self._dec_ref[peer] = recon
        return _unflatten_host(recon, payload.schema["tree"]), payload

    def _build(self, tree, peer) -> Tuple[WirePayload, Optional[np.ndarray]]:
        """Encode ``tree`` into a payload WITHOUT advancing delta state;
        returns (payload, the delta reference used or None)."""
        flat, meta = _flatten_host(tree)
        P = flat.size
        schema: Dict[str, Any] = {"codec": self.spec, "P": P, "tree": meta,
                                  "chunk": self.chunk}
        x = flat
        ref = None
        keyframe = False
        if self.delta:
            ref = self._enc_ref.get(peer)
            # keyframe: the stream's first payload establishes the
            # reference DENSE (quantized only); sparsifying an absolute payload drops
            # uniformly important entries (BN scales) and the early-round
            # damage never heals (-33 mAP on the reference's synthetic
            # bench)
            keyframe = ref is None
            if ref is None:
                ref = np.zeros_like(flat)
            x = flat - ref
        buffers: Dict[str, np.ndarray] = {}
        sparse = self.topk and not keyframe
        schema["sparse"] = sparse
        if sparse:
            schema["k"] = self.k_for(P)
            schema["group"] = self.group
            if self.group is not None:
                schema["kg"] = self.kg
                vals, idx = grouped_topk_select_host(x, self.group, self.kg)
                buffers["idx_bits"] = pack_group_indices_host(
                    idx, self.group, self.kg)
            else:
                vals, idx = topk_select_host(x, schema["k"])
                buffers["indices"] = idx
        else:
            vals = x.astype(np.float32)
        if self.quant == "int8":
            q, scales = quantize_host(vals, self.chunk)
            buffers["values"] = q
            buffers["scales"] = scales
        elif self.quant == "bf16":
            buffers["values"] = bf16_bits_host(vals)
        else:
            buffers["values"] = vals
        return WirePayload(buffers, schema), ref

    # ---- decode --------------------------------------------------------------
    def _decode_residual(self, payload: WirePayload) -> np.ndarray:
        schema = payload.schema
        v = payload.buffers["values"]
        if self.quant == "int8":
            v = dequantize_host(v, payload.buffers["scales"], schema["chunk"])
        elif self.quant == "bf16":
            v = bf16_bits_to_f32(v)
        else:
            v = np.asarray(v, np.float32)
        if schema["sparse"]:
            P = schema["P"]
            g = schema.get("group")
            if g is not None:
                idx = unpack_group_indices_host(
                    payload.buffers["idx_bits"], schema["k"], g, schema["kg"])
                Pp = ((P + g - 1) // g) * g           # grouped: padded tail
            else:
                idx = payload.buffers["indices"]
                Pp = P
            dense = np.zeros((Pp,), np.float32)
            dense[idx] = v
            return dense[:P]
        return v

    def decode(self, payload: WirePayload, peer=None):
        x = self._decode_residual(payload)
        if self.delta:
            ref = self._dec_ref.get(peer)
            x = x if ref is None else ref + x
            self._dec_ref[peer] = x
        return _unflatten_host(x, payload.schema["tree"])


def make_codec(spec: Optional[str], **overrides) -> Optional[Codec]:
    """Parse a ``+``-joined stage spec ("raw", "int8", "topk+int8",
    "delta+topk+bf16", ...) into a fresh ``PipelineCodec`` (None -> None).
    ``overrides``: keep_frac, k, group, chunk, delta.

    ``topk`` implies ``delta`` (override with ``delta=False``): stateless
    top-k of absolute parameters shrinks every aggregate entry (-4.6 mAP
    at keep_frac 0.25 on the reference's bench), while top-k of the
    residual against the decoder-visible reconstruction corrects itself.
    Same wire format either way.
    """
    if spec is None:
        return None
    stages = [s.strip() for s in spec.split("+") if s.strip()]
    unknown = [s for s in stages if s not in _STAGES]
    if unknown:
        raise ValueError(f"unknown codec stage(s) {unknown} in {spec!r}; "
                         f"known: {_STAGES}")
    quants = [s for s in stages if s in ("int8", "bf16")]
    if len(quants) > 1:
        raise ValueError(f"at most one quantization stage, got {quants}")
    topk = "topk" in stages
    delta = overrides.pop("delta", "delta" in stages or topk)
    return PipelineCodec(
        spec,
        delta=delta,
        topk=topk,
        quant=quants[0] if quants else None,
        **overrides,
    )
