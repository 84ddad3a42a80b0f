"""Knowledge relevance across the spatial-temporal dimension (paper Eq. 5).

The port of the batched server path of ``repro/core/relevance.py``. The
server keeps the last ``k`` rounds of task features of every client in a
device-resident ``(C, k, D)`` ring (age-major: the newest at age 0) with a
``(C, k)`` validity mask, and the relevance of client i's newest task to
client j is the decayed sum of similarities against j's history:

    W_ij = sum_{age < k} lambda_f^age * S(cur_i, hist_j[age]) * valid_j[age]

All pairs are one (C, C k) similarity matrix (``core.similarity``):
``metric="kl"`` goes through ``kernels.ops.kl_similarity`` (the CUDA kernel
for CUDA tensors), cosine and euclidean through their plain forms. ``RelevanceTracker`` (the host
engine's tracker and its loop oracle) belongs to the host-engine slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.similarity import pairwise_similarity


def decayed_relevance(cur, hist, decay, valid=None, *, metric: str = "kl"):
    """Batched Eq. 4/5. cur (N, D) current task features; hist (C, k, D)
    histories; decay (k,) per-age weights; valid optional (C, k) {0, 1}.
    Returns (N, C) unnormalized relevance (diagonal not masked)."""
    C, k, D = hist.shape
    S = pairwise_similarity(cur, hist.reshape(C * k, D), metric=metric)
    S = S.reshape(cur.shape[0], C, k)
    if valid is not None:
        S = S * valid[None, :, :]
    return torch.einsum("nck,k->nc", S, decay.float())


def normalize_rows(W: np.ndarray) -> np.ndarray:
    """Row-normalise, leaving all-zero rows (no relevant neighbours) zero."""
    W = np.asarray(W, np.float32)
    rows = W.sum(1, keepdims=True)
    return np.divide(W, rows, out=np.zeros_like(W), where=rows > 0)


def ring_push(buf, valid, stale, feats, mask):
    """Roll/scatter update of the ring for the rows selected by ``mask``
    (C,): their history shifts one age back and ``feats`` enters at age 0;
    other rows are untouched. ``stale`` counts rounds since each client's
    last push (pushed rows reset to 0, skipped rows age by 1). Returns new
    (buf, valid, stale)."""
    rolled = torch.roll(buf, 1, dims=1)
    rolled[:, 0] = feats
    rvalid = torch.roll(valid, 1, dims=1)
    rvalid[:, 0] = 1.0
    keep = mask > 0
    buf = torch.where(keep[:, None, None], rolled, buf)
    valid = torch.where(keep[:, None], rvalid, valid)
    stale = torch.where(keep, torch.zeros_like(stale), stale + 1.0)
    return buf, valid, stale


def ring_relevance(buf, valid, *, forgetting_ratio: float, metric: str = "kl"):
    """Unnormalized (C, C) decayed relevance over the ring: each client's
    newest feature (age 0) against every history; rows without a current
    feature are zero. The diagonal is NOT masked: the fused aggregate owns
    that."""
    k = buf.shape[1]
    decay = forgetting_ratio ** torch.arange(k, dtype=torch.float32,
                                             device=buf.device)
    W = decayed_relevance(buf[:, 0], buf, decay, valid, metric=metric)
    return W * valid[:, 0][:, None]


@dataclasses.dataclass
class DeviceRingHistory:
    """Device-resident (C, k, D) task-feature history with a (C, k)
    validity mask and the (C,) staleness counter."""

    n_clients: int
    history_len: int
    dim: int
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        C, k, D = self.n_clients, self.history_len, self.dim
        self.buf = torch.zeros((C, k, D), device=self.device)
        self.valid = torch.zeros((C, k), device=self.device)
        self.stale = torch.zeros((C,), device=self.device)

    def push_all(self, feats, mask=None):
        """feats (C, D) this round's task features; mask optional (C,)
        {0, 1} participation (rows with 0 keep their history)."""
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self.device)
        if mask is None:
            mask = torch.ones((self.n_clients,), device=self.device)
        self.buf, self.valid, self.stale = ring_push(
            self.buf, self.valid, self.stale, feats,
            torch.as_tensor(mask, dtype=torch.float32, device=self.device))

    def raw_relevance(self, *, forgetting_ratio: float, metric: str = "kl"):
        """See ``ring_relevance``."""
        return ring_relevance(self.buf, self.valid,
                              forgetting_ratio=forgetting_ratio,
                              metric=metric)
