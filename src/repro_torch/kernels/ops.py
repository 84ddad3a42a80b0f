"""Public kernel entry points: dispatch by the device the tensors lie on.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version in ``ref``. There is no
backend switch: the plain version is never taken for a CUDA tensor.
Meta tensors (the production lowering, ``launch/dryrun.py``) take the
plain versions' shapes and dtypes and allocate nothing; the four flash
stages are operators of their own (``repro_torch::flash_*``), whose meta
versions make empty outputs and whose FLOPs ``torch.utils.flop_counter``
(and ``sharding.analysis.OpCounter``) count by the kernels' own
arithmetic, the same on the card, the CPU and meta.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.common.pytree import tree_map
from repro_torch.kernels import ref as REF
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.adaptive_combine import \
    adaptive_combine_tree as _combine_tree
from repro_torch.kernels.int8_dist import \
    batched_int8_pairwise_dist as _bi8dist
from repro_torch.kernels.ivf import batched_cluster_dist as _bcdist
from repro_torch.kernels.ivf import \
    batched_ivf_shortlist_scores as _bivfshort
from repro_torch.kernels.kl_similarity import kl_similarity as _kl
from repro_torch.kernels.pairwise_dist import batched_pairwise_dist as _bpdist
from repro_torch.kernels.pairwise_dist import pairwise_dist as _pdist
from repro_torch.kernels.quantize import batched_dequantize as _bdequant
from repro_torch.kernels.quantize import batched_quantize as _bquant
from repro_torch.kernels.relevance_aggregate import \
    fused_relevance_aggregate as _fused_agg
from repro_torch.kernels.relevance_aggregate import \
    normalize_relevance as _normalize
from repro_torch.kernels.relevance_aggregate import \
    relevance_aggregate as _agg
from repro_torch.kernels.topk_pack import batched_idx_bitpack as _bidxpack
from repro_torch.kernels.topk_pack import batched_idx_bitunpack as _bidxunpack
from repro_torch.kernels.topk_pack import batched_topk_decode as _bdecode
from repro_torch.kernels.topk_pack import \
    batched_topk_decode_int8 as _bdecode8
from repro_torch.kernels.topk_pack import batched_topk_encode as _bencode
from repro_torch.kernels.topk_pack import batched_topk_pack as _btopk
from repro_torch.kernels.topk_pack import batched_topk_unpack as _buntopk


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA operands (the kernel), False for CPU ones (the plain
    version) or meta ones (its shapes); operands on more than one kind of
    device raise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cuda"}:
        return True
    if kinds in ({"cpu"}, {"meta"}):
        return False
    raise ValueError(f"operands on {sorted(kinds)}: all must lie on one "
                     "CUDA device or all on the CPU (or all on meta)")


def batched_pairwise_dist(q, g):
    """(C, Q, D) x (C, G, D) -> (C, Q, G) fp32 squared distances."""
    if _on_cuda(q, g):
        return _bpdist(q, g)
    return REF.batched_pairwise_dist_ref(q, g)


def pairwise_dist(q, g):
    """(Q, D) x (G, D) -> (Q, G) fp32 squared distances."""
    if _on_cuda(q, g):
        return _pdist(q, g)
    return REF.pairwise_dist_ref(q, g)


def batched_int8_pairwise_dist(q, gq, gscale, gn2):
    """(C, B, F) fp32 queries x int8 resident gallery ((C, G, F) codes,
    (C, G) scales, (C, G) dequantized squared norms) -> (C, B, G)."""
    if _on_cuda(q, gq, gscale, gn2):
        return _bi8dist(q, gq, gscale, gn2)
    return REF.batched_int8_pairwise_dist_ref(q, gq, gscale, gn2)


def batched_quantize(x, *, chunk: int = 256):
    """(C, P) fp32 -> ((C, P) int8, (C, ceil(P/chunk)) fp32 scales)."""
    if _on_cuda(x):
        return _bquant(x, chunk=chunk)
    return REF.batched_quantize_ref(x, chunk=chunk)


def batched_dequantize(q, scales, *, chunk: int = 256):
    """Inverse of ``batched_quantize``: (C, P) int8 + (C, ceil(P/chunk))
    fp32 scales -> (C, P) fp32."""
    if _on_cuda(q, scales):
        return _bdequant(q, scales, chunk=chunk)
    return REF.batched_dequantize_ref(q, scales, chunk=chunk)


def _products(gs, others, need):
    """[g * other] where ``need``, else None: one ``_foreach_mul`` over
    the leaves that need it (each product rounded once, as ``g * other``)."""
    idx = [i for i, k in enumerate(need) if k]
    out = [None] * len(need)
    if idx:
        prods = torch._foreach_mul([gs[i] for i in idx],
                                   [others[i] for i in idx])
        for i, p in zip(idx, prods):
            out[i] = p
    return out


class AdaptiveCombineTree(torch.autograd.Function):
    """theta = B * alpha + A over n leaves at once: ``apply(n, *bases,
    *alphas, *as_)`` -> n outputs. The forward goes through the device
    dispatch (one CUDA launch per dtype group for CUDA tensors, the plain
    version leaf by leaf for CPU ones); the backward forms autograd's
    products for the plain expression, each kind in one ``_foreach_mul``:
    d alpha = g * B, d B = g * alpha (where B needs it), d A = g."""

    @staticmethod
    def forward(ctx, n, *leaves):
        bases, alphas, as_ = leaves[:n], leaves[n:2 * n], leaves[2 * n:]
        ctx.n = n
        ctx.save_for_backward(*bases, *alphas)
        if _on_cuda(*leaves):
            contig = lambda ts: [t.contiguous() for t in ts]
            return tuple(_combine_tree(contig(bases), contig(alphas),
                                       contig(as_)))
        return tuple(REF.adaptive_combine_tree_ref(bases, alphas, as_))

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        d_b = _products(gs, saved[n:], need[:n])
        d_alpha = _products(gs, saved[:n], need[n:2 * n])
        d_a = [g if k else None for g, k in zip(gs, need[2 * n:])]
        return (None, *d_b, *d_alpha, *d_a)


def adaptive_combine_tree(B, alpha, A):
    """FedSTIL Eq. 2 over every leaf of three trees of one structure
    (nested dicts, or single tensors): differentiable, the output shaped
    as ``B`` (its keys in ``B``'s order)."""
    triples = []
    tree_map(lambda *leaf: triples.append(leaf), B, alpha, A)
    if not triples:
        return tree_map(lambda _: None, B)
    bases, alphas, as_ = zip(*triples)
    outs = iter(AdaptiveCombineTree.apply(len(bases), *bases, *alphas,
                                          *as_))
    return tree_map(lambda _: next(outs), B)


def adaptive_combine(base, alpha, a):
    """FedSTIL Eq. 2 over one leaf: base * alpha + a, differentiable (the
    tree entry over a single tensor)."""
    return adaptive_combine_tree(base, alpha, a)


def relevance_aggregate(w, thetas):
    """Eq. 6 over given rows: (R, C) fp32 relevance x (C, P) -> (R, P)."""
    if _on_cuda(w, thetas):
        return _agg(w, thetas)
    return REF.relevance_aggregate_ref(w, thetas)


def kl_similarity(a, b):
    """(N, D) x (M, D) -> (N, M) fp32 exp(-KL(softmax(a_i) || softmax(b_j)))."""
    if _on_cuda(a, b):
        return _kl(a, b)
    return REF.kl_similarity_ref(a, b)


def fused_relevance_aggregate(w, thetas):
    """Raw relevance (C, C) + stacked parameters (C, P) -> (B = Wn @ Θ
    (C, P), Wn (C, C) fp32): diagonal masked, rows normalized, zero rows
    kept zero."""
    if _on_cuda(w, thetas):
        return _fused_agg(w, thetas)
    return REF.fused_relevance_aggregate_ref(w, thetas)


def normalize_relevance(w):
    """Raw relevance (C, C) -> Wn (C, C) fp32, ``fused_relevance_aggregate``'s
    Wn alone: diagonal masked, rows normalized, zero rows kept zero."""
    if _on_cuda(w):
        return _normalize(w)
    return REF.normalized_relevance_ref(w)


def batched_cluster_assign(qf, cent, cn2, *, nprobe: int):
    """IVF coarse-quantizer stage: (C, B, F) fp32 queries x ((C, L, F)
    centroids, (C, L) squared norms) -> (C, B, nprobe) int32 nearest bucket
    ids, ties to the lowest id."""
    if _on_cuda(qf, cent, cn2):
        return REF.nearest_probes(_bcdist(qf, cent, cn2), nprobe)
    return REF.batched_cluster_assign_ref(qf, cent, cn2, nprobe=nprobe)


def batched_ivf_shortlist(qf, probe, bq, pack):
    """IVF shortlist stage: score only the probed buckets of the
    bucket-major int8 image. (C, B, F) queries + (C, B, P) probe ids x
    ((C, L, K, F) int8 rows, (C, L, 3, K) packed sidecar) -> ((C, B, P*K)
    partial squared distances, (C, B, P*K) row ids, -1 on empty slots)."""
    if _on_cuda(qf, probe, bq, pack):
        d, ids = _bivfshort(qf, probe, bq, pack)
        C, B = d.shape[:2]
        return d.reshape(C, B, -1), ids.reshape(C, B, -1)
    return REF.batched_ivf_shortlist_ref(qf, probe, bq, pack)


def batched_topk_pack(x, *, group: int = 8, kg: int):
    """Wire-codec sparsify stage: (C, P) -> (values (C, ceil(P/group)*kg)
    fp32, absolute indices int32): the kg largest magnitudes of every group
    of ``group`` contiguous elements, ties to the lowest index."""
    if _on_cuda(x):
        return _btopk(x, group=group, kg=kg)
    return REF.batched_topk_pack_ref(x, group=group, kg=kg)


def batched_topk_unpack(vals, idx, *, p: int, group: int = 8, kg: int):
    """Inverse of ``batched_topk_pack``: values + indices -> dense (C, p)
    fp32, dropped entries zero."""
    if _on_cuda(vals, idx):
        return _buntopk(vals, idx, p=p, group=group, kg=kg)
    return REF.batched_topk_unpack_ref(vals, idx, p=p, group=group, kg=kg)


def batched_idx_bitpack(idx, *, group: int = 8, kg: int):
    """Wire-codec index compression: (C, K) int32 grouped-pack indices ->
    (C, bits*ceil(K/8)) uint8 bit-planes of the local in-group index (3
    bits at group 8)."""
    if _on_cuda(idx):
        return _bidxpack(idx, group=group, kg=kg)
    return REF.batched_idx_bitpack_ref(idx, group=group, kg=kg)


def batched_idx_bitunpack(packed, *, k: int, group: int = 8, kg: int):
    """Inverse of ``batched_idx_bitpack``: uint8 bit-planes -> (C, k) int32
    absolute indices."""
    if _on_cuda(packed):
        return _bidxunpack(packed, k=k, group=group, kg=kg)
    return REF.batched_idx_bitunpack_ref(packed, k=k, group=group, kg=kg)


def batched_topk_encode(x, *, group: int = 8, kg: int):
    """The wire codec's sparse encode in one step: (C, P) -> (values (C,
    ceil(P/group)*kg) fp32, uint8 bit-planes of the local indices), as
    ``batched_topk_pack`` then ``batched_idx_bitpack``."""
    if _on_cuda(x):
        return _bencode(x, group=group, kg=kg)
    return REF.batched_topk_encode_ref(x, group=group, kg=kg)


def batched_topk_decode(vals, packed, *, k: int, p: int, group: int = 8,
                        kg: int):
    """Inverse of ``batched_topk_encode``: values + bit-planes -> dense
    (C, p) fp32, as ``batched_idx_bitunpack`` then
    ``batched_topk_unpack``."""
    if _on_cuda(vals, packed):
        return _bdecode(vals, packed, k=k, p=p, group=group, kg=kg)
    return REF.batched_topk_decode_ref(vals, packed, k=k, p=p, group=group,
                                       kg=kg)


def batched_topk_decode_int8(codes, scales, packed, *, k: int, p: int,
                             group: int = 8, kg: int, chunk: int = 256):
    """The int8 codec's decode in one step: int8 codes + chunk scales +
    bit-planes -> dense (C, p) fp32, as ``batched_dequantize`` then
    ``batched_topk_decode``."""
    if _on_cuda(codes, scales, packed):
        return _bdecode8(codes, scales, packed, k=k, p=p, group=group, kg=kg,
                         chunk=chunk)
    return REF.batched_topk_decode_int8_ref(codes, scales, packed, k=k, p=p,
                                            group=group, kg=kg, chunk=chunk)


# ---------------------------------------------------------------------------
# flash attention: four stages, each dispatched by device, and the
# differentiable op over them
# ---------------------------------------------------------------------------


# each stage is an operator of its own: the kernel for CUDA operands, the
# plain version for CPU ones, empty outputs for meta ones (its fake), and
# the kernels' FLOPs wherever a flop counter looks. The kernels compute
# only the visible (query, key) pairs: 2 hd FLOPs a pair a product, two
# products in a forward (S = Q K^T, O = P V), three in dQ (S and dP = dO
# V^T again, dQ = dS K), four in dK/dV (S, dP, dV = P^T dO, dK = dS^T Q)
_PRODUCTS = {"fwd": 2, "fwd_lse": 2, "dq": 3, "dkv": 4}


@functools.lru_cache(maxsize=256)
def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a flash call computes: key j is visible
    from query i when j <= i (causal, aligned top-left, ``ref.py``) and
    j > i - window (window > 0)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, i) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(stage: str, q_shape, k_shape, causal: bool,
                window: int) -> int:
    """FLOPs of one flash stage's kernel: 2 hd a visible pair a product,
    over every q head (zamba2's hd 80 counts 80, not the kernel's padding
    to 128)."""
    B, hq, sq, hd = q_shape
    return (2 * _PRODUCTS[stage] * B * hq * hd
            * visible_pairs(sq, k_shape[2], bool(causal), int(window)))


def _flash_op(stage, schema, kernel, plain, fake):
    """Define ``repro_torch::flash_<stage>`` over ``kernel`` / ``plain``
    with its fake and its FLOPs."""
    def impl(*args):
        *tensors, causal, window = args
        fn = kernel if _on_cuda(*tensors) else plain
        return fn(*tensors, causal=causal, window=window)

    op = torch.library.custom_op(f"repro_torch::flash_{stage}", impl,
                                 mutates_args=(), schema=schema)
    op.register_fake(fake)

    @register_flop_formula(getattr(torch.ops.repro_torch, f"flash_{stage}"))
    def _flops(q_shape, k_shape, *rest, out_shape=None, **kw):
        return flash_flops(stage, q_shape, k_shape, rest[-2], rest[-1])
    return op


_QKV = "Tensor q, Tensor k, Tensor v"
_BWD = _QKV + ", Tensor do, Tensor lse, Tensor delta"
_MASK = "bool causal, int window"
_fwd_op = _flash_op(
    "fwd", f"({_QKV}, {_MASK}) -> Tensor", _flash.flash_attention_fwd,
    REF.flash_attention_ref,
    lambda q, k, v, causal, window: torch.empty_like(q))
_fwd_lse_op = _flash_op(
    "fwd_lse", f"({_QKV}, {_MASK}) -> (Tensor, Tensor)",
    _flash.flash_attention_fwd_lse, REF.flash_attention_fwd_lse_ref,
    lambda q, k, v, causal, window: (
        torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)))
_dq_op = _flash_op(
    "dq", f"({_BWD}, {_MASK}) -> Tensor", _flash.flash_attention_dq,
    REF.flash_attention_dq_ref,
    lambda q, k, v, do, lse, delta, causal, window: torch.empty_like(q))
_dkv_op = _flash_op(
    "dkv", f"({_BWD}, {_MASK}) -> (Tensor, Tensor)",
    _flash.flash_attention_dkv, REF.flash_attention_dkv_ref,
    lambda q, k, v, do, lse, delta, causal, window: (
        torch.empty_like(k), torch.empty_like(v)))


# each wrapper checks its operands' devices first: the dispatcher alone
# would send a meta + CPU mix to the meta fake


def flash_attention_fwd(q, k, v, *, causal: bool, window: int = 0):
    """Attention alone: q (B, Hq, Sq, hd), k and v (B, Hkv, Sk, hd) -> o
    (B, Hq, Sq, hd). Causal aligned top-left (``ref.py``)."""
    _on_cuda(q, k, v)
    return _fwd_op(q, k, v, causal, window)


def flash_attention_fwd_lse(q, k, v, *, causal: bool, window: int = 0):
    """Attention and its fp32 logsumexp (B, Hq, Sq)."""
    _on_cuda(q, k, v)
    return _fwd_lse_op(q, k, v, causal, window)


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool,
                       window: int = 0):
    """dQ of attention, given dO, lse and delta = rowsum(O dO)."""
    _on_cuda(q, k, v, do, lse, delta)
    return _dq_op(q, k, v, do, lse, delta, causal, window)


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool,
                        window: int = 0):
    """(dK, dV) of attention, summed over each kv head's q heads."""
    _on_cuda(q, k, v, do, lse, delta)
    return _dkv_op(q, k, v, do, lse, delta, causal, window)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the forward + logsumexp stage and whose
    backward is the dQ and dK/dV stages (the reference's ``custom_vjp``
    in ``flash_attention_bwd.py``). delta = rowsum(O dO) in fp32 is taken
    here, outside the kernels, as the reference takes it. The stages are
    looked up on this module at call time, so a caller can reroute them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                         window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = torch.sum(o.float() * do.float(), -1)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dq = flash_attention_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool, window: int = 0):
    """Attention over (B, Hq, Sq, hd) q and (B, Hkv, Sk, hd) k, v (Hq a
    multiple of Hkv), softmax in fp32, output in q's dtype. With no
    operand that needs a gradient it is the forward stage alone;
    otherwise the differentiable ``FlashAttention``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_fwd(q, k, v, causal=causal, window=window)
