"""Federated lifelong metrics (paper Eq. 7 & 8).

Accuracy A_c^(r): average retrieval accuracy over all tasks client c has
trained on, evaluated at round r. Forgetting F_c^(r): mean drop from each
task's historical best to its current accuracy (last task excluded).

A numpy copy of ``repro/train/metrics.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class LifelongTracker:
    """Tracks per-(client, task) accuracy across rounds."""

    n_clients: int

    def __post_init__(self):
        # acc[c][task_idx] = list of (round, {metric: value})
        self.records: List[Dict[int, List]] = [dict() for _ in range(self.n_clients)]

    def record(self, client: int, task_idx: int, rnd: int, metrics: Dict[str, float]):
        self.records[client].setdefault(task_idx, []).append((rnd, metrics))

    def accuracy(self, client: int, rnd: int, key: str = "mAP") -> float:
        """Eq. (7): mean over trained tasks of their accuracy at round rnd."""
        vals = []
        for task_idx, hist in self.records[client].items():
            upto = [m[key] for (r, m) in hist if r <= rnd]
            if upto:
                vals.append(upto[-1])
        return float(np.mean(vals)) if vals else 0.0

    def forgetting(self, client: int, rnd: int, key: str = "mAP") -> float:
        """Eq. (8): mean over past tasks of (best-so-far - current)."""
        drops = []
        tasks = sorted(self.records[client])
        if len(tasks) < 2:
            return 0.0
        for task_idx in tasks[:-1]:
            hist = [(r, m[key]) for (r, m) in self.records[client][task_idx]
                    if r <= rnd]
            if len(hist) < 1:
                continue
            vals = [v for _, v in hist]
            drops.append(max(vals) - vals[-1])
        return float(np.mean(drops)) if drops else 0.0

    def mean_accuracy(self, rnd: int, key: str = "mAP") -> float:
        return float(np.mean([self.accuracy(c, rnd, key)
                              for c in range(self.n_clients)]))

    def mean_forgetting(self, rnd: int, key: str = "mAP") -> float:
        return float(np.mean([self.forgetting(c, rnd, key)
                              for c in range(self.n_clients)]))
