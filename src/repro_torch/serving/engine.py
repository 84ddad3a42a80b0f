"""Online retrieval engine: fixed-shape batched top-k over the resident index
(the port of ``repro/serving/engine.py``, modes int8, fp32 and ivf).

Query contract (shared by the int8 path, the fp32 path and the numpy host
oracle; the ivf path scores only the rows of the ``nprobe`` nearest coarse
buckets, ``query_ivf``):

  1. featurize: frozen-BN forward with the index's ``bn_mu``/``bn_sd`` +
     L2 normalization — how the gallery rows were featurized at refresh,
     and independent of batch composition;
  2. score: squared euclidean distance to every resident row (the int8
     path dequantizes through per-row scales and precomputed norms inside
     the ``batched_int8_pairwise_dist`` kernel);
  3. rank: empty slots pushed to +inf, then the k smallest distances with
     ties to the LOWEST gallery index (``lax.top_k``'s order in the
     reference, the numpy oracle's stable argsort);
  4. mask: invalid query slots (batcher padding) return id -1.
"""
from __future__ import annotations

from typing import Optional

import functools

import numpy as np
import torch

from repro_torch.analysis.registry import (meta, register_program,
                                           register_runtime)
from repro_torch.core import edge_model as EM
from repro_torch.core.convert import theta_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import ivf_metrics
from repro_torch.serving.index import GalleryIndex, l2n

_PAD_DIST = 1e30
_K = 10


def featurize(theta, bn_mu, bn_sd, qp):
    return l2n(EM.adaptive_forward_frozen(theta, qp, bn_mu, bn_sd))


def rank_topk(dist, gids, qmask, k: int):
    """(C, B, G) distances -> ((C, B, k) ids, (C, B, k) distances).

    ``torch.topk`` promises no order among equal values, so the ranking is
    a stable ascending sort: equal distances keep gallery-index order, as
    ``lax.top_k`` does in the reference."""
    C = dist.shape[0]
    dist = torch.where((gids >= 0)[:, None, :], dist, _PAD_DIST)
    d, idx = torch.sort(dist, dim=-1, stable=True)
    d, idx = d[..., :k], idx[..., :k]
    ids = torch.gather(gids, 1, idx.reshape(C, -1)).reshape(idx.shape)
    ids = torch.where(qmask[..., None] > 0, ids, -1)
    return ids, d


def _query_abstract(int8: bool):
    """Bench-scale abstract query inputs: C=8 clients x a batch of 32
    against G=4096 resident rows."""
    cfg = EM.EdgeModelConfig()
    C, B, G, F = 8, 32, 4096, cfg.feat_dim
    common = (EM.adaptive_layers_meta(cfg, C), meta(C, F), meta(C, F),
              meta(C, B, cfg.proto_dim), meta(C, B))
    if int8:
        gal = (meta(C, G, F, dtype=torch.int8), meta(C, G), meta(C, G),
               meta(C, G, dtype=torch.int32))
    else:
        gal = (meta(C, G, F), meta(C, G, dtype=torch.int32))
    return common + gal, {"k": _K}


@register_program(
    "serving.query_int8", abstract_args=lambda: _query_abstract(True),
    oracle="repro_torch.serving.engine.query_host", budget_bytes=64 << 20)
def query_int8_program(theta, bn_mu, bn_sd, qp, qmask, gq, gscale, gn2,
                       gids, *, k: int):
    """The serving fast path: (C, B, proto_dim) padded query batch against
    the int8 resident gallery -> top-k ids + squared distances, on the
    device."""
    qf = featurize(theta, bn_mu, bn_sd, qp)
    dist = ops.batched_int8_pairwise_dist(qf, gq, gscale, gn2)
    return rank_topk(dist, gids, qmask, k)


@register_program(
    "serving.query_fp32", abstract_args=lambda: _query_abstract(False),
    oracle="repro_torch.serving.engine.query_host", budget_bytes=64 << 20)
def query_fp32_program(theta, bn_mu, bn_sd, qp, qmask, gf, gids, *, k: int):
    """Exact-path twin of ``query_int8_program`` over the fp32 rows: the
    on-device parity oracle for the int8 index."""
    qf = featurize(theta, bn_mu, bn_sd, qp)
    dist = ops.batched_pairwise_dist(qf, gf)
    return rank_topk(dist, gids, qmask, k)


def _query_ivf_abstract(with_metrics: bool = False):
    cfg = EM.EdgeModelConfig()
    C, B, L, K, F = 8, 32, 64, 96, cfg.feat_dim
    return ((EM.adaptive_layers_meta(cfg, C), meta(C, F), meta(C, F),
             meta(C, B, cfg.proto_dim), meta(C, B), meta(C, L, F),
             meta(C, L), meta(C, L, K, F, dtype=torch.int8),
             meta(C, L, 3, K)),
            {"k": _K, "nprobe": 8, **({"with_metrics": True}
                                      if with_metrics else {})})


@register_program(
    "serving.query_ivf", abstract_args=_query_ivf_abstract,
    oracle="repro_torch.serving.engine.query_ivf_host",
    budget_bytes=64 << 20)
def query_ivf(theta, bn_mu, bn_sd, qp, qmask, cent, cn2, bq, pack, *,
              k: int, nprobe: int, with_metrics: bool = False):
    """The approximate serving path: featurize -> the ``nprobe`` nearest
    coarse buckets (``batched_cluster_assign``) -> score only those
    buckets' int8 rows (``batched_ivf_shortlist``) -> + |q|^2, empty slots
    out of the race -> stable top-k over the shortlist -> invalid query
    slots -1. Scores nprobe * bcap rows per query instead of G, with the
    distances of the exact int8 path, so recall@k against that path is the
    fidelity metric. ``with_metrics=True`` also returns ``ivf_metrics`` of
    this launch (rows scored, the probe ranks of the top-k hits)."""
    qf = featurize(theta, bn_mu, bn_sd, qp)
    probe = ops.batched_cluster_assign(qf, cent, cn2, nprobe=nprobe)
    d, ids = ops.batched_ivf_shortlist(qf, probe, bq, pack)
    top, d, idx = rank_shortlist(d, ids, qf, qmask, k)
    if not with_metrics:
        return top, d
    return top, d, ivf_metrics(ids, qmask, idx, bq.shape[2], nprobe)


register_runtime(
    "serving.query_ivf_metrics", functools.partial(query_ivf,
                                                   with_metrics=True),
    abstract_args=lambda: _query_ivf_abstract(True),
    module="repro_torch.serving.engine",
    oracle="repro_torch.serving.engine.query_ivf_host",
    budget_bytes=64 << 20)


def rank_shortlist(d, ids, qf, qmask, k: int):
    """(C, B, S) partial shortlist distances |g|^2 - 2 q.g and their row
    ids -> ((C, B, k) ids, distances, positions in the shortlist): + |q|^2,
    empty slots (ids < 0) out of the race, a stable ascending sort (ties to
    the lowest shortlist position, as ``lax.top_k``), invalid query slots
    -1."""
    d = d + torch.sum(torch.square(qf), -1)[..., None]
    d = torch.where(ids >= 0, d, _PAD_DIST)
    d, idx = torch.sort(d, dim=-1, stable=True)
    d, idx = d[..., :k], idx[..., :k]
    top = torch.gather(ids, 2, idx)
    return torch.where(qmask[..., None] > 0, top, -1), d, idx


def _as_np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _host_features(t, c, qp_c, mu, sd):
    """The numpy frozen-BN head of client c + L2 normalization."""
    h = np.maximum(qp_c @ t["l1.w"][c] + t["l1.b"][c], 0.0)
    f = h @ t["l2.w"][c] + t["l2.b"][c]
    f = (f - mu) / sd * t["bn.scale"][c] + t["bn.bias"][c]
    f = f / np.sqrt(np.maximum(np.sum(np.square(f), -1, keepdims=True),
                               1e-12))
    return f.astype(np.float32)


def query_ivf_host(theta, bn_mu, bn_sd, qp, qmask, cent, cn2, bq, pack, *,
                   k: int, nprobe: int):
    """Numpy oracle for ``query_ivf``: same features, nearest nprobe
    centroids by stable argsort, dequantized bucket rows scored exactly,
    empty slots masked, stable top-k."""
    t = theta_numpy(theta)
    bn_mu, bn_sd = _as_np(bn_mu), _as_np(bn_sd)
    qp, qmask = _as_np(qp).astype(np.float32), _as_np(qmask)
    cent, cn2 = _as_np(cent).astype(np.float32), _as_np(cn2).astype(np.float32)
    bq, pack = _as_np(bq), _as_np(pack).astype(np.float32)
    C, B, _ = qp.shape
    ids = np.full((C, B, k), -1, np.int32)
    dd = np.full((C, B, k), _PAD_DIST, np.float32)
    for c in range(C):
        f = _host_features(t, c, qp[c], bn_mu[c], bn_sd[c])
        qq = np.sum(np.square(f), -1)
        dc = (qq[:, None] + cn2[c][None, :] - 2.0 * f @ cent[c].T)
        probe = np.argsort(dc, axis=1, kind="stable")[:, :nprobe]
        bids_c = pack[c, :, 2, :].view(np.int32)
        for b in range(B):
            if qmask[c, b] <= 0:
                continue
            sl_ids = bids_c[probe[b]].reshape(-1)
            blk = bq[c][probe[b]].reshape(-1, bq.shape[-1]).astype(np.float32)
            scale = pack[c, probe[b], 0, :].reshape(-1)
            n2 = pack[c, probe[b], 1, :].reshape(-1)
            d = qq[b] + n2 - 2.0 * (blk @ f[b]) * scale
            d = np.where(sl_ids >= 0, d, _PAD_DIST).astype(np.float32)
            order = np.argsort(d, kind="stable")[:k]
            ids[c, b] = sl_ids[order]
            dd[c, b] = d[order]
    return ids, dd


def naive_query_one(theta_c, mu, sd, proto, gf_c, gids_c, *, k: int):
    """One query, one client, fp32: the per-query baseline the batched
    paths are measured against, on the plain 2-D distance (the reference
    calls it with ``backend="ref"`` too). ``theta_c`` is one client's head
    with a leading axis of 1."""
    qf = l2n(EM.adaptive_forward_frozen(theta_c, proto[None, None],
                                        mu[None], sd[None]))[0]
    dist = REF.pairwise_dist_ref(qf, gf_c)[0]
    dist = torch.where(gids_c >= 0, dist, _PAD_DIST)
    d, idx = torch.sort(dist, stable=True)
    return gids_c[idx[:k]], d[:k]


def recall_at_k(ids_approx: np.ndarray, ids_exact: np.ndarray,
                qmask: Optional[np.ndarray] = None) -> float:
    """Fraction of the exact path's top-k ids that the approximate path
    also returned, averaged over valid query slots (both (..., B, k)
    ranked id matrices, -1 = empty)."""
    a, e = np.asarray(ids_approx), np.asarray(ids_exact)
    hit = (e[..., :, None] == a[..., None, :]).any(-1) | (e < 0)
    per_q = hit.mean(-1)
    if qmask is not None:
        per_q = per_q[np.asarray(qmask) > 0]
    return float(per_q.mean())


def query_host(theta, bn_mu, bn_sd, qp, qmask, gf, gids, *, k: int):
    """Numpy retrieval oracle: per valid query slot, frozen-BN features ->
    exact squared distances to the valid fp32 gallery rows -> stable
    argsort -> top-k ids. Exact-match ground truth for the fp32 path."""
    t = theta_numpy(theta)
    bn_mu, bn_sd = _as_np(bn_mu), _as_np(bn_sd)
    qp, qmask = _as_np(qp).astype(np.float32), _as_np(qmask)
    gf, gids = _as_np(gf).astype(np.float32), _as_np(gids)
    C, B, _ = qp.shape
    ids = np.full((C, B, k), -1, np.int32)
    dd = np.full((C, B, k), _PAD_DIST, np.float32)
    for c in range(C):
        f = _host_features(t, c, qp[c], bn_mu[c], bn_sd[c])
        dist = (np.sum(np.square(f), -1)[:, None]
                + np.sum(np.square(gf[c]), -1)[None, :]
                - 2.0 * (f @ gf[c].T)).astype(np.float32)
        dist[:, gids[c] < 0] = _PAD_DIST
        order = np.argsort(dist, axis=1, kind="stable")[:, :k]
        for b in range(B):
            if qmask[c, b] > 0:
                ids[c, b] = gids[c][order[b]]
                dd[c, b] = dist[b, order[b]]
    return ids, dd


def ap_from_ranked_ids(ranked_ids: np.ndarray, qid: int) -> Optional[float]:
    """Average precision of one query given its full ranked id list
    (-1 = empty slot); None when the gallery holds no match."""
    match = np.asarray(ranked_ids) == qid
    n = int(match.sum())
    if n == 0:
        return None
    ranks = np.nonzero(match)[0] + 1
    return float(np.mean(np.arange(1, n + 1) / ranks))


def map_from_ranked_ids(ranked_ids: np.ndarray, qids: np.ndarray,
                        qmask: Optional[np.ndarray] = None) -> float:
    """mAP over a (B, k) ranked-id matrix (k spanning the whole gallery);
    queries with no gallery match (or masked out) are dropped."""
    aps = []
    for b, qid in enumerate(np.asarray(qids)):
        if qmask is not None and qmask[b] <= 0:
            continue
        ap = ap_from_ranked_ids(ranked_ids[b], int(qid))
        if ap is not None:
            aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


class RetrievalEngine:
    """Online top-k retrieval over a ``GalleryIndex``.

    ``mode="int8"`` queries the quantized resident image; ``mode="fp32"``
    queries the exact rows (needs ``keep_fp32=True`` on the index);
    ``mode="ivf"`` queries only the ``nprobe`` nearest coarse buckets
    (needs ``nlist > 0`` on the index; the int8 path over the same index
    is its recall oracle). ``update(theta_stacked)`` is the federated
    integration point: a new stacked head rebuilds the index in place —
    cached prototypes, no re-extraction — and the next query sees it. Runs
    on the index's device.
    """

    def __init__(self, index: GalleryIndex, theta_stacked, *, k: int = _K,
                 mode: str = "int8", nprobe: int = 8, refresh: bool = True):
        if mode not in ("int8", "fp32", "ivf"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if mode == "fp32" and not index.keep_fp32:
            raise ValueError("fp32 mode needs keep_fp32=True on the index")
        if mode == "ivf" and not index.nlist:
            raise ValueError("ivf mode needs nlist > 0 on the index")
        self.index = index
        self.k = k
        self.mode = mode
        self.nprobe = min(int(nprobe), index.nlist) if index.nlist else 0
        if refresh:
            self.update(theta_stacked)
        else:
            # share an already-refreshed index (several engines/modes over
            # one resident image)
            if index.gq is None:
                raise ValueError("refresh=False needs a refreshed index")
            self.theta = self._on_device(theta_stacked)

    @classmethod
    def from_eval_cache(cls, theta_stacked, cache, t: int, *,
                        capacity: Optional[int] = None,
                        keep_fp32: bool = True, device="cuda", **kw):
        """Serve a simulation's evaluation galleries: per-client galleries
        are the ``_EvalCache``'s prototype assembly for task horizon ``t``
        (the eval path's galleries, never re-extracted)."""
        protos, ids = zip(*(cache.host_gallery(c, t)
                            for c in range(cache.bench.n_clients)))
        index = GalleryIndex(protos, ids, capacity=capacity,
                             keep_fp32=keep_fp32, device=device)
        return cls(index, theta_stacked, **kw)

    def _on_device(self, theta):
        # serving takes no gradients: a head straight from training is
        # detached from its graph
        return {k: torch.as_tensor(v, dtype=torch.float32,
                                   device=self.index.device).detach()
                for k, v in theta.items()}

    def update(self, theta_stacked):
        """A federated round landed: swap the head, rebuild the index."""
        self.theta = self._on_device(theta_stacked)
        with obs.span("serve.index_refresh", cat="serve",
                      mode=self.mode) as sp:
            self.index.refresh(self.theta)
            sp.sync(self.index.gq)

    def extend(self, client: int, protos, ids):
        """Append gallery rows for one client and re-land the index."""
        self.index.extend(client, protos, ids)
        self.index.refresh(self.theta)

    def query_batch(self, qp, qmask, *, k: Optional[int] = None):
        """(C, B, proto_dim) padded queries + (C, B) validity -> ((C, B, k)
        ids, distances) as numpy. One pass over all clients."""
        k = self.k if k is None else k
        ix = self.index
        qp = torch.as_tensor(qp, dtype=torch.float32, device=ix.device)
        qmask = torch.as_tensor(qmask, dtype=torch.float32, device=ix.device)
        if self.mode == "ivf":
            # under a tracer the same pass also returns the probe hit-rates
            # and rows scored
            traced = obs.is_active()
            out = query_ivf(self.theta, ix.bn_mu, ix.bn_sd, qp, qmask,
                            ix.cent, ix.cn2, ix.bq, ix.pack, k=k,
                            nprobe=self.nprobe, with_metrics=traced)
            if traced:
                obs.metric("serve.ivf", out[2], nprobe=self.nprobe)
            ids, d = out[:2]
            return ids.cpu().numpy(), d.cpu().numpy()
        if self.mode == "int8":
            ids, d = query_int8_program(self.theta, ix.bn_mu, ix.bn_sd, qp,
                                        qmask, ix.gq, ix.gscale, ix.gn2,
                                        ix.gids, k=k)
        else:
            ids, d = query_fp32_program(self.theta, ix.bn_mu, ix.bn_sd, qp,
                                        qmask, ix.gf, ix.gids, k=k)
        return ids.cpu().numpy(), d.cpu().numpy()

    def query_host(self, qp, qmask, *, k: Optional[int] = None):
        """The numpy oracle at this engine's current state (always fp32)."""
        if self.index.gf is None:
            raise ValueError("host oracle needs keep_fp32=True on the index")
        return query_host(self.theta, self.index.bn_mu, self.index.bn_sd,
                          qp, qmask, self.index.gf, self.index.gids,
                          k=self.k if k is None else k)

    def query_naive(self, client: int, proto, *, k: Optional[int] = None):
        """The baseline: one fp32 query, one client, one pass."""
        ix = self.index
        if ix.gf is None:
            raise ValueError("naive path needs keep_fp32=True on the index")
        c = client
        ids, d = naive_query_one(
            {n: v[c:c + 1] for n, v in self.theta.items()}, ix.bn_mu[c],
            ix.bn_sd[c], torch.as_tensor(proto, dtype=torch.float32,
                                         device=ix.device),
            ix.gf[c], ix.gids[c], k=self.k if k is None else k)
        return ids.cpu().numpy(), d.cpu().numpy()
