"""Batched (C clients x T tasks) retrieval evaluation on the device.

The port of ``repro/evalreid/batched.py``. Query features come stacked as
padded ``(C, T, Q, F)`` tensors (one query set per task per client),
galleries as ``(C, G, F)`` padded to a common G. Every distance matrix of
the round is one ``kernels.ops.batched_pairwise_dist`` call (the CUDA
kernel for CUDA tensors), and mAP/CMC follow without sorting whole rows
into ranks:

  1. each query's gallery matches are put in (distance, gallery index)
     order by a stable sort of the row with non-matches pushed to +inf:
     the order of the numpy oracle's ``argsort(kind="stable")`` among the
     matches (``torch.topk`` does not promise ``lax.top_k``'s lowest-index
     tie order, a stable sort does);
  2. each match's full-gallery rank is counted: 1 + the gallery items
     strictly closer + the equally close ones with a lower index, an exact
     integer, so ties resolve as the stable sort resolves them;
  3. AP = mean over matches of (position among matches) / (full rank);
     R@k = best match rank <= k.

Semantics shared with the oracle (``evalreid.retrieval``): features are
L2-normalised (eps 1e-9), distances squared euclidean; queries with no
gallery match are dropped from every average; a set with no valid query
scores 0.0. Padded gallery rows sit at distance ``_PAD_DIST`` with id -1,
padded or masked queries get id -2, so padding never matches and never
shifts a real match's rank.

Memory: step 2 holds a (C, T, Q, M, G) boolean, M = ``max_matches``; it
grows as C² with the galleries, which bounds the client count one eval
round can take on one card.

``evaluate_retrieval_batched`` takes numpy arrays and returns numpy
metrics from ``batched_retrieval_metrics`` on ``device`` (the card unless
the caller names the CPU): the reference's ``backend="device"``. Its
numpy oracle is ``evalreid.retrieval.evaluate_retrieval``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.registry import meta, register_program
from repro_torch.common.device import resolve_device
from repro_torch.kernels import ops

_PAD_DIST = 1e30      # >> max squared distance of unit vectors (4.0)
_PAD_GID = -1
_PAD_QID = -2


def _l2n(x, eps=1e-9):
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def max_match_bound(qids, gids, *, qmask=None, gmask=None) -> int:
    """Host-side bound on per-query gallery matches (the ``max_matches`` of
    ``batched_retrieval_metrics``): the most often any queried identity
    appears in its client's (valid) gallery."""
    qids, gids = np.asarray(qids), np.asarray(gids)
    best = 1
    for c in range(qids.shape[0]):
        g = gids[c] if gmask is None else gids[c][np.asarray(gmask[c]) > 0]
        q = qids[c].ravel() if qmask is None else \
            qids[c].ravel()[np.asarray(qmask[c]).ravel() > 0]
        q = q[q >= 0]
        if len(g) == 0 or len(q) == 0:
            continue
        vals, cnts = np.unique(g, return_counts=True)
        hit = np.isin(vals, q)
        if hit.any():
            best = max(best, int(cnts[hit].max()))
    return best


def _metrics_abstract():
    """Bench-scale abstract eval inputs: C=100 clients x T=3 tasks."""
    C, T, Q, G, F = 100, 3, 16, 96, 64
    i32 = torch.int32
    return ((meta(C, T, Q, F), meta(C, T, Q, dtype=i32), meta(C, G, F),
             meta(C, G, dtype=i32)),
            {"qmask": meta(C, T, Q), "gmask": meta(C, G), "ranks": (1, 3, 5),
             "max_matches": 4})


@register_program(
    "evalreid.batched_retrieval_metrics", abstract_args=_metrics_abstract,
    oracle="repro_torch.evalreid.retrieval.evaluate_retrieval",
    budget_bytes=64 << 20)
def batched_retrieval_metrics(qf, qids, gf, gids, *, qmask=None, gmask=None,
                              ranks: Tuple[int, ...] = (1, 3, 5),
                              max_matches: Optional[int] = None
                              ) -> Dict[str, torch.Tensor]:
    """qf (C, T, Q, F) query features; qids (C, T, Q) identity ids; gf
    (C, G, F) gallery features; gids (C, G); qmask (C, T, Q) and gmask
    (C, G) validity (None = all valid); max_matches a bound on matches per
    query (None = G). Returns {"mAP": (C, T), "R1": ..., ...} fp32,
    averaged over each set's valid queries."""
    C, T, Q, F = qf.shape
    G = gf.shape[1]
    M = G if max_matches is None else max(1, min(int(max_matches), G))
    qn = _l2n(qf.float())
    gn = _l2n(gf.float())
    dist = ops.batched_pairwise_dist(qn.reshape(C, T * Q, F).contiguous(),
                                     gn.contiguous()).reshape(C, T, Q, G)

    gids_eff = gids.long()
    if gmask is not None:
        gvalid = gmask > 0
        dist = torch.where(gvalid[:, None, None, :], dist,
                           torch.full((), _PAD_DIST, device=dist.device))
        gids_eff = torch.where(gvalid, gids_eff,
                               torch.full((), _PAD_GID, device=gids.device))
    qids_eff = qids.long()
    if qmask is not None:
        qids_eff = torch.where(qmask > 0, qids_eff,
                               torch.full((), _PAD_QID, device=qids.device))

    m = gids_eff[:, None, None, :] == qids_eff[..., None]     # (C, T, Q, G)
    n_match = torch.sum(m.float(), -1)                          # (C, T, Q)

    # matches first, in (distance, index) order: stable ascending sort
    key = torch.where(m, dist, torch.full((), float("inf"),
                                          device=dist.device))
    match_d, midx = torch.sort(key, dim=-1, stable=True)
    match_d, midx = match_d[..., :M], midx[..., :M]             # (C, T, Q, M)
    mvalid = match_d < float("inf")

    # full-gallery stable rank of match i: 1 + #closer + #tied-and-earlier
    gdx = torch.arange(G, device=dist.device)
    d = dist[..., None, :]
    md = match_d[..., None]
    before = (d < md) | ((d == md) & (gdx < midx[..., None]))
    r = 1.0 + torch.sum(before.float(), -1)                     # (C, T, Q, M)

    pos = torch.arange(1, M + 1, dtype=torch.float32, device=dist.device)
    ap = (torch.sum(torch.where(mvalid, pos / r, torch.zeros((), device=r.device)), -1)
          / torch.clamp(n_match, min=1.0))                      # (C, T, Q)

    vf = (n_match > 0).float()
    cnt = torch.clamp(torch.sum(vf, -1), min=1.0)               # (C, T)
    best = r[..., 0]
    out = {"mAP": torch.sum(ap * vf, -1) / cnt}
    for k in ranks:
        out[f"R{k}"] = torch.sum((best <= k).float() * vf, -1) / cnt
    return out


def evaluate_retrieval_batched(qf, qids, gf, gids, *, qmask=None, gmask=None,
                               ranks: Tuple[int, ...] = (1, 3, 5),
                               max_matches: Optional[int] = None,
                               device="cuda") -> Dict[str, np.ndarray]:
    """All (c, t) retrieval evaluations at once from numpy arrays ->
    {"mAP": (C, T), "R1": ..., ...} numpy fp32: ``batched_retrieval_metrics``
    on ``device`` (distances through the CUDA kernel there; ``device="cpu"``
    takes the plain versions), with ``max_matches`` bounded on the host by
    ``max_match_bound`` unless given."""
    if max_matches is None:
        max_matches = max_match_bound(qids, gids, qmask=qmask, gmask=gmask)
    dev = resolve_device(device)

    def put(a):
        return None if a is None else torch.as_tensor(np.asarray(a),
                                                      device=dev)

    out = batched_retrieval_metrics(
        put(qf), put(qids), put(gf), put(gids), qmask=put(qmask),
        gmask=put(gmask), ranks=tuple(ranks), max_matches=int(max_matches))
    return {k: v.cpu().numpy() for k, v in out.items()}
