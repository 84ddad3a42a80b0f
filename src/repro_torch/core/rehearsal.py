"""Prototype rehearsal memory (paper §IV-A, Fig. 4).

Nearest-mean-of-exemplars (iCaRL-style) selection *in prototype space*:
when a task arrives, run its prototypes through the adaptive layers, compute
the per-identity mean of the outputs, and store the prototypes whose outputs
are closest to their identity's mean. Bounded memory, FIFO eviction across
tasks (oldest task's exemplars shrink first), replayed during training.

A numpy copy of ``repro/core/rehearsal.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class PrototypeMemory:
    capacity: int                      # max stored prototypes
    per_identity: int = 8              # exemplars per identity per task

    def __post_init__(self):
        self.protos: Optional[np.ndarray] = None   # (N, D)
        self.labels: Optional[np.ndarray] = None   # (N,)
        self.task_ids: Optional[np.ndarray] = None

    def __len__(self):
        return 0 if self.protos is None else len(self.protos)

    @property
    def size_bytes(self) -> int:
        return 0 if self.protos is None else self.protos.nbytes + self.labels.nbytes

    def add_task(self, protos, labels, outputs, task_id: int):
        """Select nearest-mean exemplars of a new task and store them.

        protos: (N, D) prototypes; outputs: (N, F) adaptive-layer outputs
        used for the mean-center distance; labels: (N,) identity ids.
        """
        protos = np.asarray(protos)
        labels = np.asarray(labels)
        outputs = np.asarray(outputs, np.float32)
        keep_idx: List[int] = []
        for ident in np.unique(labels):
            idx = np.nonzero(labels == ident)[0]
            center = outputs[idx].mean(0)
            d = np.linalg.norm(outputs[idx] - center, axis=1)
            nearest = idx[np.argsort(d)[: self.per_identity]]
            keep_idx.extend(nearest.tolist())
        keep_idx = np.asarray(keep_idx, np.int64)

        new_p = protos[keep_idx]
        new_l = labels[keep_idx]
        new_t = np.full((len(keep_idx),), task_id, np.int64)
        if self.protos is None:
            self.protos, self.labels, self.task_ids = new_p, new_l, new_t
        else:
            self.protos = np.concatenate([self.protos, new_p])
            self.labels = np.concatenate([self.labels, new_l])
            self.task_ids = np.concatenate([self.task_ids, new_t])
        self._evict()

    def _evict(self):
        """Shrink oldest tasks first until under capacity."""
        while len(self) > self.capacity:
            oldest = self.task_ids.min()
            idx = np.nonzero(self.task_ids == oldest)[0]
            n_over = len(self) - self.capacity
            drop = idx[: min(n_over, len(idx))]
            mask = np.ones(len(self), bool)
            mask[drop] = False
            self.protos = self.protos[mask]
            self.labels = self.labels[mask]
            self.task_ids = self.task_ids[mask]
            if mask.all():   # safety
                break

    def sample(self, rng: np.random.Generator, n: int):
        """Sample up to n stored prototypes for rehearsal."""
        if self.protos is None or len(self) == 0 or n <= 0:
            return None
        idx = rng.choice(len(self), size=min(n, len(self)), replace=False)
        return self.protos[idx], self.labels[idx]
