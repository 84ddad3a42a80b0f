"""Device-resident per-client gallery index for online ReID retrieval
(the port of ``repro/serving/index.py``: flat int8 / fp32 image and IVF).

Layout (leading axis C = clients, fixed capacity G rows per client):

  host side (the cloud's copy, never re-extracted):
    gp         (C, G, proto_dim) fp32   gallery prototypes (Eq. 1 outputs)
    gids_host  (C, G) int32             person ids, -1 = empty slot
  device side (rebuilt by ``refresh`` when a federated round lands a new
  adaptive head; prototypes are reused, only the head math reruns):
    gq         (C, G, feat_dim) int8    quantized L2-normalized features
    gscale     (C, G) fp32              per-row symmetric scale (absmax/127)
    gn2        (C, G) fp32              |dequant(row)|^2
    gids       (C, G) int32             device copy of gids_host
    bn_mu/sd   (C, feat_dim) fp32       BN statistics frozen over each
                                        client's valid gallery rows
    gf         (C, G, feat_dim) fp32    exact rows, kept only with
                                        ``keep_fp32=True``

The prototypes also stay on the device (``extend`` writes new rows to both
copies), so a head swap moves no prototype bytes across PCIe.

IVF image (``nlist > 0``; built by the same refresh, so the coarse quantizer
always matches the head that produced the rows):

    cent  (C, nlist, F) fp32        coarse centroids (balanced k-means over
                                    the valid dequantized rows)
    cn2   (C, nlist) fp32           |centroid|^2
    bq    (C, nlist, bcap, F) int8  bucket-major copy of the row codes
                                    (empty slots zeroed)
    pack  (C, nlist, 3, bcap) fp32  [row scale; dequant |g|^2; person id
                                    bitcast int32->fp32]: one contiguous
                                    sidecar read per probed bucket
    binv  (C, nlist, bcap) int32    gallery row index per slot (-1 empty;
                                    every valid row sits in exactly one slot)

nlist ~ sqrt(2G) buckets of bcap ~ 1.4 G / nlist slots; a mild count-balance
penalty in Lloyd keeps buckets under capacity, and overflow rows spill into
empty slots elsewhere, so none is dropped and a full probe (nprobe = nlist)
scores the whole gallery.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.registry import meta, register_program
from repro_torch.common.device import resolve_device
from repro_torch.core import edge_model as EM
from repro_torch.core.convert import theta_numpy
from repro_torch.kernels import ops

_EPS = 1e-12


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp(torch.sum(torch.square(x), -1,
                                                keepdim=True), min=_EPS))


def index_features(theta, gp, gmask):
    """The head over the cached prototypes: (C, G, proto_dim) + (C, G)
    validity -> (L2-normalized features with empty rows zeroed, BN mu, sd)."""
    f = EM.adaptive_pre_bn(theta, gp)
    mu, sd = EM.adaptive_bn_stats(f, gmask)
    fn = EM.adaptive_bn_apply(theta, f, mu, sd)
    return l2n(fn) * gmask[..., None], mu, sd


def _refresh_abstract(ivf: bool = False):
    """Bench-scale abstract refresh inputs: C=8 clients x G=4096 rows."""
    cfg = EM.EdgeModelConfig()
    C, G = 8, 4096
    args = (EM.adaptive_layers_meta(cfg, C), meta(C, G, cfg.proto_dim),
            meta(C, G))
    if not ivf:
        return args, {}
    return (args + (meta(C, G, dtype=torch.int32),),
            {"nlist": 64, "bcap": 96, "iters": 4, "train_cap": 2048,
             "balance": 0.1})


@register_program(
    "serving.index_refresh", abstract_args=_refresh_abstract,
    oracle="repro_torch.serving.index.refresh_host", budget_bytes=192 << 20)
def index_refresh(theta, gp, gmask):
    """Rebuild the resident image under a stacked head -> (int8 codes,
    per-row scales, dequantized squared norms, BN mu, BN sd, fp32 rows).

    Features are L2-normalized before quantization so every row shares the
    same dynamic range; empty slots are zeroed (scale 1, norm 0)."""
    fn, mu, sd = index_features(theta, gp, gmask)
    C, G, F = fn.shape
    q8, scales = ops.batched_quantize(fn.reshape(C, G * F), chunk=F)
    gq = q8.reshape(C, G, F)
    gn2 = torch.sum(torch.square(gq.float()), -1) * torch.square(scales)
    return gq, scales, gn2, mu, sd, fn


def _take_rows(x, idx):
    """x (C, N, ...) gathered along the row axis by idx (C, M) -> (C, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _assign_chunked(rows, cent, pen, chunk: int):
    """Nearest penalized centroid of every row, ``chunk`` rows at a time so
    the (N, L) distances never materialize: rows (C, N, F), cent (C, L, F),
    pen (C, L) -> (C, N) int64, ties to the first centroid."""
    cn2 = torch.sum(cent * cent, -1)
    out = []
    for i in range(0, rows.shape[1], chunk):
        cr = rows[:, i:i + chunk]
        d = (torch.sum(cr * cr, -1, keepdim=True) + cn2[:, None, :]
             - torch.bmm(2.0 * cr, cent.transpose(1, 2)))
        out.append(torch.argmin(d + pen[:, None, :], -1))
    return torch.cat(out, 1)


def ivf_build(deq, gmask, *, nlist: int, bcap: int, iters: int,
              train_cap: int, balance: float):
    """Fixed-shape balanced k-means and capacity placement, all C clients
    at once: deq (C, G, F) dequantized rows, gmask (C, G) validity ->
    (cent (C, nlist, F), cn2 (C, nlist), binv (C, nlist, bcap) int32 row
    indices, -1 = empty slot).

    Valid rows are compacted to a prefix by argsort; Lloyd runs over a
    strided subsample with a count-balance penalty ``balance *
    (est_count / target - 1)`` added to the assignment metric (query-time
    probing stays unpenalized); placement is a stable sort by (bucket,
    row): a bucket's first bcap rows take its slots, and overflow rows
    spill, in row order, into the leftover empty slots in slot order
    (nlist * bcap >= G is validated by the index). The same steps as the
    reference's per-client build; the segment sums are a one-hot product,
    which the card computes the same way every time (a scatter-add of
    floats there is atomic and its sums depend on the launch), so a
    refresh with the same head is bit-identical."""
    C, G, F = deq.shape
    dev = deq.device
    valid = gmask > 0
    g_idx = torch.arange(G, device=dev)
    vorder = torch.argsort(torch.where(valid, g_idx, G + g_idx), dim=1)
    nv = torch.clamp(valid.sum(1), min=1)                        # (C,) int64
    nv_f = nv.float()
    S = min(G, train_cap)
    # strided picks in int64: the reference's int32 products sit just under
    # 2**31 at S = 16384, G = 131072 and agree wherever they do not overflow
    tsel = _take_rows(vorder, (torch.arange(S, device=dev) * nv[:, None]) // S)
    train = _take_rows(deq, tsel)                                # (C, S, F)
    tm = _take_rows(gmask, tsel)             # all-invalid client -> zeros
    csel = _take_rows(vorder,
                      (torch.arange(nlist, device=dev) * nv[:, None]) // nlist)
    cent = _take_rows(deq, csel)
    # the reference divides by the constant nlist, which XLA compiles to a
    # multiply by its fp32 reciprocal: the same product here (filled on the
    # device: a tensor made from host data would be a blocking copy, a
    # sync in the middle of the refresh)
    target = torch.clamp(
        nv_f * torch.full((), 1.0 / nlist, dtype=torch.float32, device=dev),
        min=1e-6)[:, None]                                       # (C, 1)
    onehot_ids = torch.arange(nlist, device=dev)[None, :, None]
    wtrain = train * tm[..., None]
    scale = nv_f / torch.clamp(tm.sum(1), min=1.0)               # (C,)
    cnt_est = torch.ones((C, nlist), device=dev) * target   # zero penalty
    for _ in range(iters):
        pen = balance * (cnt_est / target - 1.0)
        a = _assign_chunked(train, cent, pen, 512)
        onehot = (a[:, None, :] == onehot_ids).float()           # (C, L, S)
        seg = torch.bmm(onehot, wtrain)
        cnt = torch.bmm(onehot, tm[..., None])[..., 0]
        cent = torch.where(cnt[..., None] > 0,
                           seg / torch.clamp(cnt[..., None], min=1.0), cent)
        cnt_est = cnt * scale[:, None]
    pen = balance * (cnt_est / target - 1.0)
    a = _assign_chunked(deq, cent, pen, 2048)
    a = torch.where(valid, a, nlist)        # invalid rows sort past the end
    # stable sort by (bucket, row); rank within a bucket from the run starts
    order = torch.argsort(a * (G + 1) + g_idx, dim=1)
    a_s = torch.gather(a, 1, order)
    change = torch.ones_like(valid)
    change[:, 1:] = a_s[:, 1:] != a_s[:, :-1]
    first = torch.cummax(torch.where(change, g_idx, 0), dim=1).values
    rank = g_idx - first
    valid_s = a_s < nlist
    primary = valid_s & (rank < bcap)
    NS = nlist * bcap
    # scatter into NS + 1 slots: the last is the reference's dropped write
    inv = torch.full((C, NS + 1), -1, dtype=torch.int64, device=dev)
    inv.scatter_(1, torch.where(primary, a_s * bcap + rank, NS),
                 torch.where(primary, order, -1))
    # overflow rows -> leftover empty slots (count(spill) <= count(empty)
    # since NS >= G >= nv); both sides sorted ascending -> deterministic
    spill = torch.sort(torch.where(valid_s & ~primary, order, G), 1).values
    empty = torch.sort(torch.where(inv[:, :NS] < 0,
                                   torch.arange(NS, device=dev), NS), 1).values
    npair = min(G, NS)
    ok = spill[:, :npair] < G
    inv.scatter_(1, torch.where(ok, empty[:, :npair], NS),
                 torch.where(ok, spill[:, :npair], -1))
    cn2 = torch.sum(cent * cent, -1)
    return cent, cn2, inv[:, :NS].reshape(C, nlist, bcap).int()


@register_program(
    "serving.index_refresh_ivf",
    abstract_args=lambda: _refresh_abstract(ivf=True),
    oracle="repro_torch.serving.index.ivf_refresh_host",
    budget_bytes=256 << 20)
def index_refresh_ivf(theta, gp, gmask, gids, *, nlist: int, bcap: int,
                      iters: int, train_cap: int, balance: float):
    """``index_refresh`` and the IVF coarse quantizer in one call: the flat
    int8 image exactly as without IVF (the exact int8 queries keep
    working), k-means over the valid dequantized rows, then the inverted
    lists gathered bucket-major (codes and packed sidecar), so a probed
    bucket is one contiguous read at query time -> (gq, scales, gn2, mu,
    sd, fn, cent, cn2, bq, pack, binv)."""
    gq, scales, gn2, mu, sd, fn = index_refresh(theta, gp, gmask)
    C, G, F = gq.shape
    deq = gq.float() * scales[..., None]
    cent, cn2, binv = ivf_build(deq, gmask, nlist=nlist, bcap=bcap,
                                iters=iters, train_cap=train_cap,
                                balance=balance)
    present = binv >= 0
    flat = torch.clamp(binv, min=0).reshape(C, nlist * bcap).long()
    bq = _take_rows(gq, flat).reshape(C, nlist, bcap, F)
    bq = torch.where(present[..., None], bq, 0)

    def sidecar(x, empty):
        return torch.where(present,
                           _take_rows(x, flat).reshape(C, nlist, bcap), empty)

    # stacked as int32 bit patterns, so no float op touches the ids' bits
    pack = torch.stack([sidecar(scales, 1.0).view(torch.int32),
                        sidecar(gn2, 0.0).view(torch.int32),
                        sidecar(gids, -1).int()], dim=2).view(torch.float32)
    return gq, scales, gn2, mu, sd, fn, cent, cn2, bq, pack, binv


def ivf_refresh_host(theta, gp, gmask, gids, *, nlist: int, bcap: int,
                     iters: int, train_cap: int, balance: float):
    """Numpy oracle for ``index_refresh_ivf`` (a copy of the reference's):
    the flat image via ``refresh_host``, then the same balanced Lloyd (same
    strided init, same penalty, same iteration count) and the same sorted
    placement in numpy. Centroids are allclose (the reduction order
    differs, so boundary rows may flip buckets: the structural invariants,
    not bit-equal lists, are the contract)."""
    q, s, n2, mu, sd, fn = refresh_host(theta, gp, gmask)
    gids = np.asarray(gids)
    gmask = np.asarray(gmask, np.float32)
    C, G, F = q.shape
    deq = q.astype(np.float32) * s[..., None]
    cents, cn2s, invs = [], [], []
    for c in range(C):
        valid = gmask[c] > 0
        g_idx = np.arange(G, dtype=np.int32)
        vorder = np.argsort(np.where(valid, g_idx, G + g_idx), kind="stable")
        nv = max(int(valid.sum()), 1)
        S = min(G, train_cap)
        tpick = (np.arange(S, dtype=np.int64) * nv) // S
        train = deq[c][vorder[tpick]]
        tm = gmask[c][vorder[tpick]]
        cpick = (np.arange(nlist, dtype=np.int64) * nv) // nlist
        cent = deq[c][vorder[cpick]].copy()
        target = max(nv / nlist, 1e-6)
        cnt_est = np.full(nlist, target, np.float32)
        for _ in range(iters):
            pen = balance * (cnt_est / target - 1.0)
            d = ((train * train).sum(-1)[:, None]
                 + (cent * cent).sum(-1)[None] - 2.0 * train @ cent.T)
            a = np.argmin(d + pen[None], -1)
            seg = np.zeros_like(cent)
            np.add.at(seg, a, train * tm[:, None])
            cnt = np.zeros(nlist, np.float32)
            np.add.at(cnt, a, tm)
            nz = cnt > 0
            cent[nz] = seg[nz] / cnt[nz, None]
            cnt_est = cnt * (nv / max(tm.sum(), 1.0))
        pen = balance * (cnt_est / target - 1.0)
        d = ((deq[c] * deq[c]).sum(-1)[:, None]
             + (cent * cent).sum(-1)[None] - 2.0 * deq[c] @ cent.T)
        a = np.argmin(d + pen[None], -1)
        a = np.where(valid, a, nlist)
        inv = np.full((nlist, bcap), -1, np.int32)
        spill = []
        for l in range(nlist):
            rows = np.nonzero(a == l)[0]
            inv[l, :min(len(rows), bcap)] = rows[:bcap]
            spill.extend(rows[bcap:])
        empties = np.argwhere(inv < 0)
        for r, (l, sl) in zip(sorted(spill), empties):
            inv[l, sl] = r
        cents.append(cent.astype(np.float32))
        cn2s.append((cent * cent).sum(-1).astype(np.float32))
        invs.append(inv)
    cent = np.stack(cents)
    cn2 = np.stack(cn2s)
    binv = np.stack(invs)
    present = binv >= 0
    flat = np.maximum(binv, 0).reshape(C, nlist * bcap)
    take = np.take_along_axis
    bq = np.where(present[..., None],
                  take(q, flat[:, :, None], axis=1).reshape(C, nlist, bcap, F),
                  0).astype(np.int8)
    bscale = np.where(present, take(s, flat, 1).reshape(C, nlist, bcap),
                      1.0).astype(np.float32)
    bn2 = np.where(present, take(n2, flat, 1).reshape(C, nlist, bcap),
                   0.0).astype(np.float32)
    bids = np.where(present, take(gids, flat, 1).reshape(C, nlist, bcap),
                    -1).astype(np.int32)
    pack = np.stack([bscale, bn2, bids.view(np.float32)], axis=2)
    return q, s, n2, mu, sd, fn, cent, cn2, bq, pack, binv


def refresh_host(theta, gp, gmask):
    """Numpy oracle for ``index_refresh``: identical head math, masked BN
    statistics, L2 normalization, and per-row symmetric int8 quantization
    (round half to even, clip to ±127, scale 1.0 for empty rows)."""
    t = theta_numpy(theta)
    gp = np.asarray(gp, np.float32)
    gmask = np.asarray(gmask, np.float32)
    C = gp.shape[0]
    out_q, out_s, out_n2, out_mu, out_sd, out_f = [], [], [], [], [], []
    for c in range(C):
        h = np.maximum(gp[c] @ t["l1.w"][c] + t["l1.b"][c], 0.0)
        f = h @ t["l2.w"][c] + t["l2.b"][c]
        m = gmask[c][:, None]
        n = max(float(gmask[c].sum()), 1.0)
        mu = (f * m).sum(0) / n
        sd = np.sqrt((np.square(f - mu[None, :]) * m).sum(0) / n) + 1e-5
        fn = (f - mu) / sd * t["bn.scale"][c] + t["bn.bias"][c]
        fn = fn / np.sqrt(np.maximum(np.sum(np.square(fn), -1,
                                            keepdims=True), _EPS))
        fn = (fn * m).astype(np.float32)
        scale = np.abs(fn).max(-1) / 127.0
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        q = np.clip(np.round(fn / scale[:, None]), -127, 127).astype(np.int8)
        n2 = (np.square(q.astype(np.float32)).sum(-1)
              * np.square(scale)).astype(np.float32)
        out_q.append(q)
        out_s.append(scale)
        out_n2.append(n2)
        out_mu.append(mu.astype(np.float32))
        out_sd.append(sd.astype(np.float32))
        out_f.append(fn)
    return (np.stack(out_q), np.stack(out_s), np.stack(out_n2),
            np.stack(out_mu), np.stack(out_sd), np.stack(out_f))


class GalleryIndex:
    """Fixed-capacity per-client gallery with a device-resident int8 image.

    Host arrays are the source of truth (``extend`` appends rows there and
    to the device copy of the prototypes); the queryable image is rebuilt
    by ``refresh(theta_stacked)`` — one pass per head swap, no prototype
    re-extraction, the IVF image included when ``nlist > 0``. ``device``
    defaults to the card and raises without one.
    """

    def __init__(self, protos: Sequence[np.ndarray], ids: Sequence[np.ndarray],
                 *, capacity: Optional[int] = None, keep_fp32: bool = True,
                 nlist=0, bcap: Optional[int] = None, ivf_iters: int = 8,
                 ivf_train_cap: Optional[int] = None,
                 ivf_balance: float = 0.1, device="cuda"):
        C = len(protos)
        if C == 0:
            raise ValueError("need at least one client")
        self.device = resolve_device(device)
        counts = [len(p) for p in protos]
        G = capacity if capacity is not None else max(max(counts), 1)
        if max(counts) > G:
            raise ValueError(f"capacity {G} < largest client gallery "
                             f"{max(counts)}")
        Dp = int(np.asarray(protos[0]).shape[-1])
        self.keep_fp32 = keep_fp32
        # IVF shapes (fixed, like capacity): nlist="auto" = sqrt(2G) buckets
        # (a query touches nlist centroids + nprobe * bcap rows); bcap ~1.4x
        # the mean occupancy, rounded up to 32, so the balance penalty keeps
        # nearly every bucket under capacity
        if nlist == "auto":
            nlist = max(8, int(round((2 * G) ** 0.5)))
        self.nlist = int(nlist or 0)
        if self.nlist:
            if bcap is None:
                bcap = -(-int(1.4 * G / self.nlist) // 32) * 32
            self.bcap = int(bcap)
            if self.nlist * self.bcap < G:
                raise ValueError(
                    f"nlist*bcap = {self.nlist}*{self.bcap} < capacity {G}"
                    " — every row needs a slot")
            if self.nlist * (G + 1) >= 2 ** 31:
                raise ValueError("nlist*(G+1) overflows the reference's "
                                 "int32 sort key")
            self.ivf_iters = int(ivf_iters)
            self.ivf_train_cap = int(ivf_train_cap
                                     if ivf_train_cap is not None
                                     else min(G, 32 * self.nlist))
            self.ivf_balance = float(ivf_balance)
        else:
            self.bcap = 0
        self.gp = np.zeros((C, G, Dp), np.float32)
        self.gids_host = np.full((C, G), -1, np.int32)
        self._fill = np.zeros((C,), np.int64)
        for c, (p, y) in enumerate(zip(protos, ids)):
            n = len(p)
            self.gp[c, :n] = np.asarray(p, np.float32)
            self.gids_host[c, :n] = np.asarray(y, np.int32)
            self._fill[c] = n
        self.gp_dev = torch.tensor(self.gp, device=self.device)   # a copy
        # device image — populated by refresh()
        self.gq = self.gscale = self.gn2 = None
        self.bn_mu = self.bn_sd = self.gids = self.gf = None
        self.cent = self.cn2 = self.bq = self.pack = self.binv = None

    @property
    def n_clients(self) -> int:
        return self.gp.shape[0]

    @property
    def capacity(self) -> int:
        return self.gp.shape[1]

    @property
    def fill(self) -> List[int]:
        return [int(n) for n in self._fill]

    @property
    def has_ivf(self) -> bool:
        return self.nlist > 0 and self.cent is not None

    def resident_bytes(self, mode: str = "int8") -> int:
        """Device bytes of the queryable image (all C clients): int8 =
        codes + scale + norm + ids; fp32 = rows + ids; ivf = the
        bucket-major codes + packed sidecar + centroids and their norms
        (queried instead of the flat image)."""
        C, G = self.gids_host.shape
        F = EM.EdgeModelConfig().feat_dim
        if mode == "int8":
            return C * G * (F + 4 + 4 + 4)
        if mode == "fp32":
            return C * G * (4 * F + 4)
        if mode == "ivf":
            slots = self.nlist * self.bcap
            return C * (slots * (F + 12) + self.nlist * (4 * F + 4))
        raise ValueError(f"unknown image mode {mode!r}")

    def extend(self, client: int, protos: np.ndarray, ids: np.ndarray):
        """Append gallery rows for one client (the next ``refresh`` lands
        them in the image). Raises when capacity is hit — capacity is a
        fixed-shape contract, not a ring buffer."""
        n0 = int(self._fill[client])
        n = len(protos)
        if n0 + n > self.capacity:
            raise ValueError(f"client {client}: {n0}+{n} rows exceed "
                             f"capacity {self.capacity}")
        self.gp[client, n0:n0 + n] = np.asarray(protos, np.float32)
        self.gids_host[client, n0:n0 + n] = np.asarray(ids, np.int32)
        self.gp_dev[client, n0:n0 + n] = torch.from_numpy(
            self.gp[client, n0:n0 + n]).to(self.device)
        self._fill[client] = n0 + n

    def refresh(self, theta_stacked):
        """Swap in a new stacked head: rerun the head math over the cached
        prototypes and replace the resident image (with the IVF coarse
        quantizer and bucket-major image when ``nlist > 0``)."""
        self.gids = torch.tensor(self.gids_host, device=self.device)
        gmask = (self.gids >= 0).float()
        if self.nlist:
            (gq, gscale, gn2, mu, sd, gf, self.cent, self.cn2, self.bq,
             self.pack, self.binv) = index_refresh_ivf(
                theta_stacked, self.gp_dev, gmask, self.gids,
                nlist=self.nlist, bcap=self.bcap, iters=self.ivf_iters,
                train_cap=self.ivf_train_cap, balance=self.ivf_balance)
        else:
            gq, gscale, gn2, mu, sd, gf = index_refresh(theta_stacked,
                                                        self.gp_dev, gmask)
        self.gq, self.gscale, self.gn2 = gq, gscale, gn2
        self.bn_mu, self.bn_sd = mu, sd
        self.gf = gf if self.keep_fp32 else None
        return self
