"""Person ReID retrieval evaluation: mAP and CMC (rank-k accuracy).

Query features are matched against a cross-camera gallery by euclidean
distance over L2-normalised features. A numpy copy of
``repro/evalreid/retrieval.py``: the per-(client, task) oracle of the
port's batched evaluation (``evalreid.batched``), whose distance matrices
go through ``kernels.ops.batched_pairwise_dist``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def l2_normalize(x, eps=1e-9):
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


def distance_matrix(qf, gf):
    """Squared euclidean over normalized features: (Q, G)."""
    qf = l2_normalize(np.asarray(qf, np.float32))
    gf = l2_normalize(np.asarray(gf, np.float32))
    # ||q-g||^2 = 2 - 2 q.g for unit vectors
    return 2.0 - 2.0 * (qf @ gf.T)


def evaluate_retrieval(query_feats, query_ids, gallery_feats, gallery_ids,
                       ranks=(1, 3, 5)) -> Dict[str, float]:
    """Returns {"mAP": ..., "R1": ..., "R3": ..., "R5": ...} in [0, 1]."""
    dist = distance_matrix(query_feats, gallery_feats)
    gids = np.asarray(gallery_ids)
    qids = np.asarray(query_ids)
    # stable sort: deterministic tie order, and the same order the batched
    # device path produces (jnp.argsort is stable)
    order = np.argsort(dist, axis=1, kind="stable")
    matches = gids[order] == qids[:, None]          # (Q, G) sorted by rank

    valid = matches.any(axis=1)
    if not valid.any():
        return {"mAP": 0.0, **{f"R{k}": 0.0 for k in ranks}}
    m = matches[valid]

    # mAP
    cum_hits = np.cumsum(m, axis=1)
    ranks_idx = np.arange(1, m.shape[1] + 1)[None, :]
    precision = cum_hits / ranks_idx
    ap = (precision * m).sum(1) / np.maximum(m.sum(1), 1)
    out = {"mAP": float(ap.mean())}
    for k in ranks:
        out[f"R{k}"] = float(m[:, :k].any(axis=1).mean())
    return out
