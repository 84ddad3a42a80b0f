"""Online retrieval engine: fixed-shape batched top-k over the resident index
(the port of ``repro/serving/engine.py``, modes int8 and fp32).

Query contract (shared by the int8 path, the fp32 path and the numpy host
oracle):

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

import numpy as np
import torch

from repro_torch.core import edge_model as EM
from repro_torch.core.convert import theta_numpy
from repro_torch.kernels import ops
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
    as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
    bn_mu, bn_sd = as_np(bn_mu), as_np(bn_sd)
    qp, qmask = as_np(qp).astype(np.float32), as_np(qmask)
    gf, gids = as_np(gf).astype(np.float32), as_np(gids)
    C, B, _ = qp.shape
    ids = np.full((C, B, k), -1, np.int32)
    dd = np.full((C, B, k), _PAD_DIST, np.float32)
    for c in range(C):
        h = np.maximum(qp[c] @ t["l1.w"][c] + t["l1.b"][c], 0.0)
        f = h @ t["l2.w"][c] + t["l2.b"][c]
        f = (f - bn_mu[c]) / bn_sd[c] * t["bn.scale"][c] + t["bn.bias"][c]
        f = f / np.sqrt(np.maximum(np.sum(np.square(f), -1, keepdims=True),
                                   1e-12))
        f = f.astype(np.float32)
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
    queries the exact rows (needs ``keep_fp32=True`` on the index).
    ``update(theta_stacked)`` is the federated integration point: a new
    stacked head rebuilds the index in place — cached prototypes, no
    re-extraction — and the next query sees it. Runs on the index's device.
    """

    def __init__(self, index: GalleryIndex, theta_stacked, *, k: int = _K,
                 mode: str = "int8", refresh: bool = True):
        if mode == "ivf":
            raise NotImplementedError(
                "mode='ivf' is not ported yet: it comes with the IVF "
                "serving slice")
        if mode not in ("int8", "fp32"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if mode == "fp32" and not index.keep_fp32:
            raise ValueError("fp32 mode needs keep_fp32=True on the index")
        self.index = index
        self.k = k
        self.mode = mode
        if refresh:
            self.update(theta_stacked)
        else:
            # share an already-refreshed index (several engines/modes over
            # one resident image)
            if index.gq is None:
                raise ValueError("refresh=False needs a refreshed index")
            self.theta = self._on_device(theta_stacked)

    def _on_device(self, theta):
        return {k: torch.as_tensor(v, dtype=torch.float32,
                                   device=self.index.device)
                for k, v in theta.items()}

    def update(self, theta_stacked):
        """A federated round landed: swap the head, rebuild the index."""
        self.theta = self._on_device(theta_stacked)
        self.index.refresh(self.theta)

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
        qf = featurize(self.theta, ix.bn_mu, ix.bn_sd, qp)
        if self.mode == "int8":
            dist = ops.batched_int8_pairwise_dist(qf, ix.gq, ix.gscale, ix.gn2)
        else:
            dist = ops.batched_pairwise_dist(qf, ix.gf)
        ids, d = rank_topk(dist, ix.gids, qmask, k)
        return ids.cpu().numpy(), d.cpu().numpy()

    def query_host(self, qp, qmask, *, k: Optional[int] = None):
        """The numpy oracle at this engine's current state (always fp32)."""
        if self.index.gf is None:
            raise ValueError("host oracle needs keep_fp32=True on the index")
        return query_host(self.theta, self.index.bn_mu, self.index.bn_sd,
                          qp, qmask, self.index.gf, self.index.gids,
                          k=self.k if k is None else k)
