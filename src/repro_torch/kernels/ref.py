"""Plain PyTorch versions of the port's kernels.

Same arithmetic, in the same expression order, as ``repro.kernels.ref``:
``x / scale`` is a division (not a multiply by the reciprocal), rounding is
``torch.round`` (half to even). The CPU tests run these against the JAX
package; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _decode_attention


def batched_pairwise_dist_ref(q, g):
    """Per-client squared euclidean: (C,Q,D) x (C,G,D) -> (C,Q,G), fp32."""
    q = q.float()
    g = g.float()
    qq = torch.sum(q * q, -1)[:, :, None]
    gg = torch.sum(g * g, -1)[:, None, :]
    return qq + gg - 2.0 * torch.bmm(q, g.transpose(1, 2))


def batched_int8_pairwise_dist_ref(q, gq, gscale, gn2):
    """fp32 queries vs the int8 resident gallery: (C, B, F) x ((C, G, F)
    int8 codes, (C, G) per-row scales, (C, G) dequantized squared norms)
    -> (C, B, G) squared distances to the dequantized rows."""
    q = q.float()
    qq = torch.sum(q * q, -1)[:, :, None]
    dot = torch.bmm(q, gq.float().transpose(1, 2))
    return qq + gn2[:, None, :] - 2.0 * (dot * gscale[:, None, :])


def batched_quantize_ref(x, *, chunk: int = 256):
    """Per-chunk symmetric int8 quantization of stacked rows: (C, P) fp32
    -> ((C, P) int8, (C, ceil(P/chunk)) fp32 scales). Each chunk of
    ``chunk`` contiguous elements shares scale = absmax * fl32(1/127) (1.0
    for an all-zero chunk); round half to even, clip to [-127, 127]."""
    C, P = x.shape
    nc = (P + chunk - 1) // chunk
    xp = F.pad(x.float(), (0, nc * chunk - P))
    xc = xp.reshape(C, nc, chunk)
    absmax = torch.amax(torch.abs(xc), dim=2, keepdim=True)
    # the reference's `absmax / 127.0` is a multiply by the fp32 reciprocal
    # once compiled (XLA rewrites division by a constant; PyTorch's CUDA div
    # does the same for a scalar divisor), 1 ulp off IEEE division for a few
    # percent of chunks: write that product, so every version agrees bit
    # for bit
    scale = absmax * (1.0 / 127.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xc / scale), -127.0, 127.0).to(torch.int8)
    return q.reshape(C, nc * chunk)[:, :P].contiguous(), scale[..., 0]


def batched_dequantize_ref(q, scales, *, chunk: int = 256):
    """Inverse of ``batched_quantize_ref``: (C, P) int8 codes x (C,
    ceil(P/chunk)) per-chunk fp32 scales -> (C, P) fp32, one product per
    element (the tail chunk of a ragged P is padded with zero codes, as in
    the reference)."""
    C, P = q.shape
    nc = scales.shape[1]
    qp = F.pad(q, (0, nc * chunk - P)).float()
    out = qp.reshape(C, nc, chunk) * scales[..., None]
    return out.reshape(C, nc * chunk)[:, :P]


def adaptive_combine_ref(base, alpha, a):
    """FedSTIL Eq. 2: theta = base * alpha + a, elementwise (the product
    and the sum each rounded)."""
    return base * alpha + a


def adaptive_combine_tree_ref(bases, alphas, as_):
    """``adaptive_combine_ref`` leaf by leaf over flat lists."""
    return [adaptive_combine_ref(b, al, a)
            for b, al, a in zip(bases, alphas, as_)]


def relevance_aggregate_ref(w, thetas):
    """FedSTIL Eq. 6 over given rows: (R, C) x (C, P) -> (R, P) in thetas'
    dtype, fp32 sums."""
    return (w.float() @ thetas.float()).to(thetas.dtype)


def kl_log_shift(D: int) -> float:
    """fp32 log(D): the shift both versions add to log p and log q."""
    return float(torch.tensor(math.log(D), dtype=torch.float32))


def kl_similarity_ref(a, b):
    """exp(-KL(softmax(a_i) || softmax(b_j))): (N, D) x (M, D) -> (N, M)
    fp32, with h = sum(p log p) per row of ``a`` and the cross term
    p . log q one fp32 product.

    Both terms are taken over log p + log D and log q + log D: the shift
    cancels exactly in cross - h (both weigh it by the same p), and it
    centres the summands near 0 for near-uniform rows, where h and cross
    would each be about -log D. Unshifted, their fp32 sums carry errors of
    a few ulps of log D (~2e-6 in S at D = 128); shifted, about 2e-7."""
    a = a.float()
    b = b.float()
    shift = kl_log_shift(a.shape[-1])
    p = torch.softmax(a, -1)
    logp = torch.log_softmax(a, -1)
    logq = torch.log_softmax(b, -1)
    h = torch.sum(p * (logp + shift), -1)                       # (N,)
    cross = p @ (logq + shift).T                                # (N, M)
    return torch.exp(-(h[:, None] - cross))


def normalize_relevance_ref(w):
    """Diagonal-masked, row-normalized relevance (C, C) fp32: the diagonal
    is replaced (``where``, so junk there never leaks, NaN included), rows
    are divided by their sums, and rows that do not sum above zero stay
    zero."""
    C = w.shape[0]
    eye = torch.eye(C, dtype=torch.bool, device=w.device)
    wm = torch.where(eye, torch.zeros((), device=w.device), w.float())
    rows = torch.sum(wm, 1, keepdim=True)
    pos = rows > 0
    return torch.where(pos, wm / torch.where(pos, rows, torch.ones_like(rows)),
                       torch.zeros((), device=w.device))


def fused_relevance_aggregate_ref(w, thetas, lo=0, hi=None):
    """FedSTIL's server tail (Eq. 5 post-processing + Eq. 6): raw relevance
    w (C, C) and stacked parameters thetas (C, P) -> (B = Wn @ thetas in
    thetas' dtype (fp32 sums), Wn (C, C) fp32). With a column block lo..hi,
    thetas holds the rows lo..hi only, and B = Wn[:, lo:hi] @ thetas (C,
    P)."""
    wn = normalize_relevance_ref(w)
    return (wn[:, lo:hi] @ thetas.float()).to(thetas.dtype), wn


def pairwise_dist_ref(q, g):
    """Squared euclidean (Q, D) x (G, D) -> (Q, G), fp32: the 2-D plain
    version the per-query baseline uses (``_naive_query_one`` in the
    reference calls it with ``backend="ref"`` too)."""
    q = q.float()
    g = g.float()
    qq = torch.sum(q * q, -1)[:, None]
    gg = torch.sum(g * g, -1)[None, :]
    return qq + gg - 2.0 * (q @ g.T)


def batched_cluster_dist_ref(qf, cent, cn2):
    """IVF coarse distances: (C, B, F) fp32 queries x ((C, L, F)
    centroids, (C, L) their squared norms) -> (C, B, L) as
    |q|^2 + cn2 - 2 q.c (the norms are given, not recomputed)."""
    q = qf.float()
    qq = torch.sum(q * q, -1)
    return (qq[..., None] + cn2[:, None, :]
            - 2.0 * torch.bmm(q, cent.float().transpose(1, 2)))


def nearest_probes(dc, nprobe: int):
    """(C, B, L) coarse distances -> (C, B, nprobe) int32 bucket ids,
    nearest first, ties to the lowest id (``lax.top_k(-dc, nprobe)``'s
    order; a stable ascending sort, since ``torch.topk`` promises none)."""
    return torch.sort(dc, dim=-1, stable=True)[1][..., :nprobe].int(
    ).contiguous()


def batched_cluster_assign_ref(qf, cent, cn2, *, nprobe: int):
    """IVF probe selection: (C, B, F) queries x ((C, L, F) centroids,
    (C, L) squared norms) -> (C, B, nprobe) int32 nearest bucket ids."""
    return nearest_probes(batched_cluster_dist_ref(qf, cent, cn2), nprobe)


def pack_ids(pack):
    """(C, L, 3, K) packed sidecar -> (C, L, K) int32 row ids (the third
    row, bitcast back from fp32)."""
    return pack[:, :, 2, :].contiguous().view(torch.int32)


def batched_ivf_shortlist_scores_ref(qf, probe, bq, pack):
    """Score the probed buckets of the bucket-major int8 image:
    (C, B, F) queries + (C, B, P) probe ids x ((C, L, K, F) int8 rows,
    (C, L, 3, K) [scale; |g|^2; id bitcast] sidecar) -> ((C, B, P, K)
    partial squared distances |g|^2 - 2 (q.code) s, (C, B, P, K) int32
    row ids, -1 on empty slots)."""
    C = qf.shape[0]
    cidx = torch.arange(C, device=qf.device)[:, None, None]
    pl = probe.long()
    blk = bq[cidx, pl].float()                               # (C, B, P, K, F)
    pk = pack[cidx, pl]                                      # (C, B, P, 3, K)
    dot = torch.matmul(blk, qf.float()[:, :, None, :, None])[..., 0]
    d = pk[..., 1, :] - 2.0 * (dot * pk[..., 0, :])
    return d, pack_ids(pack)[cidx, pl]


def batched_ivf_shortlist_ref(qf, probe, bq, pack):
    """``batched_ivf_shortlist_scores_ref`` flattened over the probes:
    ((C, B, P*K) partial distances, (C, B, P*K) row ids). The caller adds
    |q|^2 and masks ids < 0 before ranking."""
    d, ids = batched_ivf_shortlist_scores_ref(qf, probe, bq, pack)
    C, B = d.shape[:2]
    return d.reshape(C, B, -1), ids.reshape(C, B, -1)


def grouped_topk_rank_ref(x, *, group: int):
    """Exact within-group magnitude ranks of stacked rows: (C, P) (P a
    multiple of ``group``) -> (C, P // group, group) int32, 0 = largest
    magnitude. The rank of element i counts the j with |x_j| > |x_i|, or
    |x_j| == |x_i| and j < i: ties go to the lowest index, so the ranks of
    finite rows are a permutation of 0..group-1."""
    C, P = x.shape
    a = torch.abs(x.float()).reshape(C, P // group, group)
    ai = a[..., :, None]                                     # rank of i ...
    aj = a[..., None, :]                                     # ... vs every j
    ii = torch.arange(group, device=x.device)
    beats = (aj > ai) | ((aj == ai) & (ii[None, :] < ii[:, None]))
    return torch.sum(beats, dim=-1, dtype=torch.int32)


def batched_topk_pack_ref(x, *, group: int, kg: int):
    """Grouped top-k sparsify + pack: (C, P) -> (values (C, nb*kg) fp32,
    absolute indices (C, nb*kg) int32), nb = ceil(P / group). Every group
    of ``group`` contiguous elements keeps its ``kg`` largest magnitudes
    in rank order; the tail group reads zeros past P, which are selected
    (value 0, index >= P) when it has fewer than kg real elements. Values
    and indices are one-hot sums, as in the reference."""
    C, P = x.shape
    nb = (P + group - 1) // group
    xp = F.pad(x.float(), (0, nb * group - P))
    rank = grouped_topk_rank_ref(xp, group=group)            # (C, nb, G)
    onehot = rank[..., None] == torch.arange(kg, device=x.device)
    vals = torch.sum(xp.reshape(C, nb, group)[..., None] * onehot.float(),
                     dim=2)                                  # (C, nb, kg)
    gidx = (torch.arange(nb, dtype=torch.int32, device=x.device)[:, None]
            * group + torch.arange(group, dtype=torch.int32,
                                   device=x.device)[None, :])
    idx = torch.sum(gidx[None, :, :, None] * onehot.int(), dim=2,
                    dtype=torch.int32)
    return vals.reshape(C, nb * kg), idx.reshape(C, nb * kg)


def batched_topk_unpack_ref(vals, idx, *, p: int, group: int, kg: int):
    """Inverse of ``batched_topk_pack_ref``: (C, nb*kg) values + absolute
    indices -> dense (C, p) fp32. Slot s of group g adds its value at local
    index idx - g*group; a local index outside 0..group-1 adds nothing and
    duplicates sum."""
    C, K = vals.shape
    nb = K // kg
    dev = vals.device
    vb = vals.float().reshape(C, nb, kg)
    li = (idx.reshape(C, nb, kg)
          - (torch.arange(nb, dtype=torch.int32, device=dev)
             * group)[None, :, None])
    onehot = li[..., None] == torch.arange(group, dtype=torch.int32,
                                           device=dev)
    dense = torch.sum(vb[..., None] * onehot.float(), dim=2)
    return dense.reshape(C, nb * group)[:, :p]


def batched_idx_bitpack_ref(idx, *, group: int, kg: int):
    """Bit-pack grouped top-k indices: (C, K) int32 absolute indices ->
    (C, bits * ceil(K/8)) uint8, bits = (group-1).bit_length() (3 at
    group 8). Slot s carries its local index li = idx - (s // kg) * group;
    plane j, byte b holds bit j of li for slots 8b..8b+7 (slot s at bit
    s % 8); slots past K pack 0. int32 shifts and masks, so a local index
    outside 0..group-1 packs the same bits as in the reference."""
    C, K = idx.shape
    dev = idx.device
    bits = (group - 1).bit_length()
    kb = (K + 7) // 8
    slot = torch.arange(K, dtype=torch.int32, device=dev)
    li = idx.int() - (slot // kg)[None, :] * group
    lib = F.pad(li, (0, kb * 8 - K)).reshape(C, kb, 8)
    lane = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.int32, device=dev),
        torch.arange(8, dtype=torch.int32, device=dev))
    planes = [torch.sum(((lib >> j) & 1) * lane, dim=2, dtype=torch.int32)
              for j in range(bits)]
    return torch.cat(planes, dim=1).to(torch.uint8)


def batched_idx_bitunpack_ref(packed, *, k: int, group: int, kg: int):
    """Inverse of ``batched_idx_bitpack_ref``: (C, bits * kb) uint8
    bit-planes -> (C, k) int32 absolute indices (slot s: its group base
    (s // kg) * group plus the unpacked local index)."""
    C = packed.shape[0]
    dev = packed.device
    bits = (group - 1).bit_length()
    kb = packed.shape[1] // bits
    b = packed.reshape(C, bits, kb).int()
    lanes = (b[..., None] >> torch.arange(8, dtype=torch.int32,
                                          device=dev)) & 1
    planes = lanes.reshape(C, bits, kb * 8)[:, :, :k]
    shift = torch.arange(bits, dtype=torch.int32, device=dev)[None, :, None]
    li = torch.sum(planes << shift, dim=1, dtype=torch.int32)
    slot = torch.arange(k, dtype=torch.int32, device=dev)
    return (slot // kg)[None, :] * group + li


def batched_topk_encode_ref(x, *, group: int, kg: int):
    """The codec's encode: ``batched_topk_pack_ref`` then
    ``batched_idx_bitpack_ref`` -> (values (C, nb*kg) fp32, bit-planes
    (C, bits * ceil(nb*kg/8)) uint8)."""
    vals, idx = batched_topk_pack_ref(x, group=group, kg=kg)
    return vals, batched_idx_bitpack_ref(idx, group=group, kg=kg)


def batched_topk_decode_ref(vals, packed, *, k: int, p: int, group: int,
                            kg: int):
    """The codec's decode: ``batched_idx_bitunpack_ref`` then
    ``batched_topk_unpack_ref`` -> dense (C, p) fp32."""
    idx = batched_idx_bitunpack_ref(packed, k=k, group=group, kg=kg)
    return batched_topk_unpack_ref(vals, idx, p=p, group=group, kg=kg)


def batched_topk_decode_int8_ref(codes, scales, packed, *, k: int, p: int,
                                 group: int, kg: int, chunk: int = 256):
    """The int8 codec's decode: ``batched_dequantize_ref`` of the (C, k)
    codes and their chunk scales, then ``batched_topk_decode_ref`` ->
    dense (C, p) fp32."""
    return batched_topk_decode_ref(
        batched_dequantize_ref(codes, scales, chunk=chunk), packed, k=k, p=p,
        group=group, kg=kg)


# ---------------------------------------------------------------------------
# flash attention: forward, forward + logsumexp, dQ, dK/dV
# ---------------------------------------------------------------------------
#
# q (B, Hq, Sq, hd), k and v (B, Hkv, Sk, hd) with Hq = Hkv * R: q head h
# reads kv head h // R, the (KVg, R) order of the reference's
# ``_project_qkv``. Softmax in fp32 with scale 1/sqrt(hd) applied to q (the
# Pallas kernels' ``q * scale``); outputs in q's dtype, logsumexp in fp32.
#
# Causal convention: key kpos is visible from query qpos when kpos <= qpos,
# aligned top-left, which is the Pallas kernels' rule
# (``flash_attention.py:46``) and ``chunked_attention``'s with q0 = k0 = 0.
# The JAX package's ``ref.flash_attention_ref`` aligns bottom-right
# (kpos <= qpos + Sk - Sq); all three agree when Sq = Sk, the only case
# ``attention_block`` sends. ``window > 0`` also hides kpos <= qpos -
# window (``models/layers.py:344``), causal or not. Masked entries get
# probability 0, so a row that sees no key at all comes out 0 (the Pallas
# kernel would average v there); no row of a causal call is such a row.

FLASH_NEG_INF = -1e30


def flash_mask(sq: int, sk: int, *, causal: bool, window: int, device):
    """(Sq, Sk) bool: which keys each query sees."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def _per_q_head(kv, hq: int):
    """(B, Hkv, S, hd) -> (B, Hq, S, hd) fp32, kv head g repeated R times."""
    r = hq // kv.shape[1]
    kv = kv.float()
    return kv if r == 1 else kv.repeat_interleave(r, dim=1)


def _flash_scores(q, k, *, causal, window):
    """fp32 scores (q * scale) . k with masked entries at -1e30, and the
    mask."""
    hd = q.shape[-1]
    s = (q.float() * (1.0 / math.sqrt(hd))) @ \
        _per_q_head(k, q.shape[1]).transpose(-1, -2)
    mask = flash_mask(q.shape[2], k.shape[2], causal=causal, window=window,
                      device=q.device)
    return torch.where(mask, s, FLASH_NEG_INF), mask


def flash_attention_fwd_lse_ref(q, k, v, *, causal: bool, window: int = 0):
    """Attention and its fp32 logsumexp: -> (o (B, Hq, Sq, hd) in q's
    dtype, lse (B, Hq, Sq) fp32 = m + log max(l, 1e-30))."""
    s, mask = _flash_scores(q, k, causal=causal, window=window)
    m = torch.amax(s, -1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = torch.clamp(torch.sum(p, -1), min=1e-30)
    o = (p @ _per_q_head(v, q.shape[1])) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def flash_attention_ref(q, k, v, *, causal: bool, window: int = 0):
    """Attention alone (the forward stage): o (B, Hq, Sq, hd), q's dtype."""
    return flash_attention_fwd_lse_ref(q, k, v, causal=causal,
                                       window=window)[0]


# the forward stage's plain version under its dispatcher's name
# (``ops.flash_attention_fwd``)
flash_attention_fwd_ref = flash_attention_ref


def _flash_ds(q, k, v, do, lse, delta, *, causal, window):
    """P = exp(s - lse) (0 where masked) and dS = P (dO V^T - delta) scale."""
    s, mask = _flash_scores(q, k, causal=causal, window=window)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = do.float() @ _per_q_head(v, q.shape[1]).transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    return p, ds


def flash_attention_dq_ref(q, k, v, do, lse, delta, *, causal: bool,
                           window: int = 0):
    """dQ = sum_k dS K with P = exp(s - lse), dS = P (dO V^T - delta)
    scale; ``lse`` from the forward, delta = rowsum(O dO), both (B, Hq,
    Sq) fp32. -> (B, Hq, Sq, hd) in q's dtype."""
    _, ds = _flash_ds(q, k, v, do, lse, delta, causal=causal, window=window)
    return (ds @ _per_q_head(k, q.shape[1])).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, *, causal: bool,
                            window: int = 0):
    """dK = dS^T Q and dV = P^T dO, summed over the R q heads of each kv
    head: -> (dk, dv), each (B, Hkv, Sk, hd) in k's dtype."""
    p, ds = _flash_ds(q, k, v, do, lse, delta, causal=causal, window=window)
    B, hkv, sk, hd = k.shape
    r = q.shape[1] // hkv
    dv = (p.transpose(-1, -2) @ do.float()).reshape(B, hkv, r, sk, hd)
    dk = (ds.transpose(-1, -2) @ q.float()).reshape(B, hkv, r, sk, hd)
    return dk.sum(2).to(k.dtype), dv.sum(2).to(v.dtype)


# the decode attention's plain version lives beside its wrapper
decode_attention_ref = _decode_attention.decode_attention_ref
