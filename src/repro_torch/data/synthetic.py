"""Synthetic federated lifelong ReID benchmark.

The five real datasets (Market-1501, PKU-ReID, PersonX, Prid2011,
DukeMTMC-reID) are not available offline (repro band: data gate), so this
module simulates the paper's experimental structure:

  * a global pool of person identities, each with a base appearance vector;
  * C edge clients = non-overlapping camera views, each with a fixed
    camera transform (domain shift) plus per-round drift (a random walk on
    the transform — "camera environments are dynamic and ever-changing");
  * SPATIAL-TEMPORAL CORRELATION by construction: identities move between
    adjacent clients over rounds (a pedestrian seen at client c in round t
    tends to appear at client c+1 in round t+1) — exactly the structure
    FedSTIL's Eq. (5) relevance is designed to mine;
  * 6 sequential tasks per client, 60/40 train/query split, gallery drawn
    from *other* clients' camera views (paper §V-A.1).

All arrays are numpy, generated deterministically from the seed. A copy
of ``repro/data/synthetic.py``: the same seed gives the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class Task:
    train_x: np.ndarray     # (N_train, img_dim) raw "images"
    train_y: np.ndarray     # (N_train,) global identity ids
    query_x: np.ndarray     # (N_query, img_dim)
    query_y: np.ndarray
    client: int
    round: int


@dataclasses.dataclass
class FederatedReIDBenchmark:
    n_clients: int = 5
    n_tasks: int = 6
    img_dim: int = 256
    n_identities: int = 200
    ids_per_task: int = 24
    samples_per_id: int = 10
    train_frac: float = 0.6
    drift_scale: float = 0.15
    camera_scale: float = 0.5
    move_prob: float = 0.7       # P(identity moves to the next client)
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        C, T, D = self.n_clients, self.n_tasks, self.img_dim
        # identity appearance bases
        self.identity_base = rng.standard_normal((self.n_identities, D)).astype(np.float32)
        # per-camera (client) affine transforms
        self.cam_rot = np.stack([
            np.eye(D, dtype=np.float32)
            + self.camera_scale * rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D)
            for _ in range(C)])
        self.cam_bias = (self.camera_scale
                         * rng.standard_normal((C, D)).astype(np.float32))
        # per-round drift: random walk on a per-client bias
        drift = rng.standard_normal((C, T, D)).astype(np.float32) * self.drift_scale
        self.drift = np.cumsum(drift, axis=1)

        # identity trajectories over clients (ring movement = ST correlation)
        start = rng.integers(0, C, size=self.n_identities)
        self.location = np.zeros((T, self.n_identities), np.int64)
        loc = start.copy()
        for t in range(T):
            self.location[t] = loc
            move = rng.random(self.n_identities) < self.move_prob
            loc = (loc + move.astype(np.int64)) % C

        self._tasks: Dict[Tuple[int, int], Task] = {}
        for t in range(T):
            for c in range(C):
                self._tasks[(c, t)] = self._make_task(rng, c, t)

    # ------------------------------------------------------------------
    def _render(self, rng, ident, client, t, n):
        """n noisy views of identity `ident` under client `client`'s camera."""
        base = self.identity_base[ident]
        views = base[None] + 0.3 * rng.standard_normal(
            (n, self.img_dim)).astype(np.float32)
        x = views @ self.cam_rot[client].T + self.cam_bias[client] + self.drift[client, t]
        return x.astype(np.float32)

    def _make_task(self, rng, c, t) -> Task:
        here = np.nonzero(self.location[t] == c)[0]
        if len(here) >= self.ids_per_task:
            ids = rng.choice(here, self.ids_per_task, replace=False)
        else:  # top up with random ids (sparse rounds)
            extra = rng.choice(self.n_identities,
                               self.ids_per_task - len(here), replace=False)
            ids = np.concatenate([here, extra])
        xs, ys = [], []
        for ident in ids:
            xs.append(self._render(rng, ident, c, t, self.samples_per_id))
            ys.append(np.full((self.samples_per_id,), ident, np.int64))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = rng.permutation(len(x))
        x, y = x[perm], y[perm]
        n_train = int(len(x) * self.train_frac)
        return Task(train_x=x[:n_train], train_y=y[:n_train],
                    query_x=x[n_train:], query_y=y[n_train:],
                    client=c, round=t)

    # ------------------------------------------------------------------
    def task(self, client: int, t: int) -> Task:
        return self._tasks[(client, t)]

    def gallery(self, exclude_client: int, upto_task: int):
        """Cross-camera gallery: other clients' query splits, tasks <= t."""
        xs, ys = [], []
        for c, t in self.gallery_members(exclude_client, upto_task):
            task = self._tasks[(c, t)]
            xs.append(task.query_x)
            ys.append(task.query_y)
        return np.concatenate(xs), np.concatenate(ys)

    def gallery_members(self, exclude_client: int, upto_task: int):
        """The (client, task) keys whose query splits make up ``gallery``,
        in gallery concatenation order — lets callers assemble gallery
        prototypes from already-extracted per-task prototypes."""
        return [(c, t) for (c, t) in self._tasks
                if c != exclude_client and t <= upto_task]

    @property
    def n_classes(self) -> int:
        return self.n_identities
