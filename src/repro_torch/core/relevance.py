"""Knowledge relevance across the spatial-temporal dimension (paper Eq. 5).

The port of ``repro/core/relevance.py``. The server keeps the last ``k`` rounds of task features of every client in a
device-resident ``(C, k, D)`` ring (age-major: the newest at age 0) with a
``(C, k)`` validity mask, and the relevance of client i's newest task to
client j is the decayed sum of similarities against j's history:

    W_ij = sum_{age < k} lambda_f^age * S(cur_i, hist_j[age]) * valid_j[age]

All pairs are one (C, C k) similarity matrix (``core.similarity``):
``metric="kl"`` goes through ``kernels.ops.kl_similarity`` (the CUDA kernel
for CUDA tensors), cosine and euclidean through their plain forms.

``RelevanceTracker`` is the host engine's server state: per-client host
lists of task features (the loop oracle's layout, ``backend="loop"``: one
per-pair similarity at a time, KL with 1e-12 inside the logs) mirrored
into a ``DeviceRingHistory`` on the run's device, from which the batched
path computes all pairs at once. Rows are normalized over j != i, so Eq. 6
is a convex combination of the neighbours' parameters.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.similarity import SIMILARITY_FNS, pairwise_similarity


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


@dataclasses.dataclass
class RelevanceTracker:
    """The host server's task-feature histories and Eq. 4/5 relevance.

    ``backend``: None = the batched path over the device ring (kernels by
    the ring's device), ``"loop"`` = the per-pair reference. ``device`` is
    where the ring lives (the run's device); the next ``push_all`` moves
    the ring there when it changes."""

    n_clients: int
    history_len: int = 6           # k in Eq. (5)
    forgetting_ratio: float = 0.5  # lambda_f
    metric: str = "kl"
    backend: Optional[str] = None
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        if self.backend not in (None, "loop"):
            raise ValueError(f"backend {self.backend!r}: None (kernels by "
                             "device) or 'loop'")
        # history[c]: task features, most recent last (the oracle layout)
        self.history: List[list] = [[] for _ in range(self.n_clients)]
        self._ring: Optional[DeviceRingHistory] = None
        self._ring_dirty = False   # host lists diverged (per-client push)

    def push(self, client: int, task_feature):
        h = self.history[client]
        h.append(np.asarray(task_feature, np.float32))
        if len(h) > self.history_len:
            h.pop(0)
        self._ring_dirty = True

    def push_all(self, feats, mask=None):
        """feats (C, D) for all clients at once, mask an optional (C,)
        participation indicator: one roll/scatter of the device ring and
        the same push into the host lists."""
        feats = np.asarray(feats, np.float32)
        if mask is None:
            mask = np.ones((self.n_clients,), np.float32)
        mask = np.asarray(mask, np.float32)
        if (self._ring is None or self._ring_dirty
                or self._ring.device != torch.device(self.device)):
            # (re)build the ring from the host lists, then go resident
            self._ring = DeviceRingHistory(self.n_clients, self.history_len,
                                           feats.shape[-1], self.device)
            stacked = self.stacked_history()
            if stacked is not None:
                self._ring.buf = torch.from_numpy(stacked[0]).to(self.device)
                self._ring.valid = torch.from_numpy(stacked[1]).to(
                    self.device)
            self._ring_dirty = False
        self._ring.push_all(feats, mask)
        for c in range(self.n_clients):
            if mask[c] > 0:
                h = self.history[c]
                h.append(feats[c].copy())
                if len(h) > self.history_len:
                    h.pop(0)

    def stacked_history(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Dense (C, k, D) age-major history (most recent at age 0) and the
        (C, k) validity mask; None while every history is empty."""
        C, k = self.n_clients, self.history_len
        D = next((h[-1].shape[-1] for h in self.history if h), None)
        if D is None:
            return None
        dense = np.zeros((C, k, D), np.float32)
        valid = np.zeros((C, k), np.float32)
        for j, h in enumerate(self.history):
            for age, feat in enumerate(reversed(h)):
                if age >= k:
                    break
                dense[j, age] = feat
                valid[j, age] = 1.0
        return dense, valid

    def relevance(self, backend: Optional[str] = None) -> np.ndarray:
        """W (C, C) numpy: row i = normalized relevance of neighbours j."""
        b = backend if backend is not None else self.backend
        if b == "loop":
            return self._relevance_loop()
        return self._relevance_batched()

    def _relevance_batched(self) -> np.ndarray:
        C, k = self.n_clients, self.history_len
        if self._ring is not None and not self._ring_dirty:
            dense, valid = self._ring.buf, self._ring.valid
        else:
            stacked = self.stacked_history()
            if stacked is None:
                return np.zeros((C, C), np.float32)
            dense, valid = (torch.from_numpy(a).to(self.device)
                            for a in stacked)
        cur = dense[:, 0]                      # each client's newest feature
        has_cur = valid[:, 0]                  # rows without history stay 0
        decay = self.forgetting_ratio ** np.arange(k, dtype=np.float32)
        W = decayed_relevance(cur, dense, torch.from_numpy(decay).to(
            dense.device), valid, metric=self.metric)
        # the diagonal is masked by multiplying with (1 - I), as the
        # reference's host path does (the fused kernel selects instead)
        W = W * has_cur[:, None] * (1.0 - torch.eye(C, device=W.device))
        return normalize_rows(W.cpu().numpy())

    def _relevance_loop(self) -> np.ndarray:
        """The O(C^2 k) per-pair reference."""
        C = self.n_clients
        fn = SIMILARITY_FNS[self.metric]
        W = np.zeros((C, C), np.float32)
        for i in range(C):
            if not self.history[i]:
                continue
            cur = torch.from_numpy(self.history[i][-1])
            for j in range(C):
                if i == j or not self.history[j]:
                    continue
                acc, hj = 0.0, self.history[j]
                for age, feat in enumerate(reversed(hj)):
                    if age >= self.history_len:
                        break
                    s = float(fn(cur, torch.from_numpy(feat)))
                    acc += (self.forgetting_ratio ** age) * s
                W[i, j] = acc
        return normalize_rows(W)
