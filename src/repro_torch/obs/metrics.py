"""Round and serving metrics, ported from ``repro/obs/metrics.py``.

Device-side helpers compute the round's observables on tensors, on the
device that holds them: relevance row mass / sparsity and ring staleness
(``relevance_metrics``) and IVF probe hit-rates (``ivf_metrics``). The
engines compute them only when a tracer is active, and the tracer reads
them back.

The host-side stats are copies (pure numpy there too; the port keeps its
own rather than importing them): ``LatencyHistogram`` (fixed log-spaced
buckets; exact p50/p99 *from the buckets*, i.e. the reported percentile is
a bucket upper edge — a bounded-relative-error quantile that never stores
per-sample data), ``RollingMeter`` (windowed QPS), and ``ServeStats``
bundling the histograms + queue-depth and DRR deficit snapshots the
``ContinuousBatcher`` records into.
"""
from __future__ import annotations

import collections
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def relevance_metrics(W, valid, stale):
    """Per-client observables of one server relevance step: ``W`` (C, C)
    relevance, ``valid`` the (C, k) ring validity, ``stale`` the (C,)
    rounds-since-last-contribution counter -> (C,) row mass, row density
    (the share of peers attended), self weight (Eq. 5 self-affinity), ring
    fill and staleness."""
    return {"row_mass": W.sum(dim=1),
            "row_density": (W > 0).float().mean(dim=1),
            "self_weight": torch.diagonal(W),
            "hist_fill": valid.sum(dim=1),
            "staleness": stale}


def ivf_metrics(ids, qmask, idx, bcap: int, nprobe: int):
    """IVF shortlist observables of one query launch: ``ids`` (C, B,
    nprobe*bcap) shortlist row ids (-1 = empty slot), ``qmask`` (C, B),
    ``idx`` (C, B, k) top-k positions into the shortlist -> rows scored per
    client (C,) and the probe-rank histogram of the final top-k hits
    (C, nprobe): hit mass at the last probe ranks means nprobe is too small
    for the workload."""
    m = qmask[:, :, None]
    rows_scored = torch.sum((ids >= 0) & (m > 0), dim=(1, 2))
    probe_of_hit = idx // bcap                                   # (C, B, k)
    onehot = probe_of_hit[..., None] == torch.arange(nprobe,
                                                     device=idx.device)
    probe_hits = torch.sum(onehot * m[..., None], dim=(1, 2))    # (C, nprobe)
    return {"rows_scored": rows_scored, "probe_hits": probe_hits}


class LatencyHistogram:
    """Fixed log-spaced latency buckets with exact percentiles *of the
    bucketed distribution*.

    Buckets span [lo, hi) seconds in ``n`` log-uniform steps plus an
    overflow bucket; each recorded sample costs one ``searchsorted``.
    ``percentile(q)`` returns the upper edge of the bucket where the
    cumulative count first reaches ``ceil(q/100 * n)`` — an upper bound on
    the true sample percentile, tight to one bucket's relative width (~15%
    at the default 64 buckets over 10µs–10s).
    """

    def __init__(self, lo: float = 1e-5, hi: float = 10.0, n: int = 64):
        self.edges = np.logspace(math.log10(lo), math.log10(hi), n + 1)
        self.counts = np.zeros(n + 1, dtype=np.int64)   # [+overflow]
        self.n = 0
        self.sum = 0.0

    def record(self, seconds: float) -> None:
        i = int(np.searchsorted(self.edges, seconds, side="right"))
        # i==0 -> below lo: clamp into the first bucket; i>n -> overflow.
        self.counts[min(max(i - 1, 0), len(self.counts) - 1)] += 1
        self.n += 1
        self.sum += seconds

    def record_many(self, seconds) -> None:
        for s in np.asarray(seconds, dtype=np.float64).ravel():
            self.record(float(s))

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-th percentile sample.
        Empty histogram -> nan; one sample -> that sample's bucket edge
        for every q."""
        if self.n == 0:
            return float("nan")
        rank = max(1, math.ceil(q / 100.0 * self.n))
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank))
        return float(self.edges[min(i + 1, len(self.edges) - 1)])

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else float("nan")

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if self.edges.shape != other.edges.shape:
            raise ValueError("histograms with different buckets")
        self.counts += other.counts
        self.n += other.n
        self.sum += other.sum
        return self

    def snapshot(self) -> Dict[str, Any]:
        return {"n": int(self.n), "mean_s": self.mean,
                "p50_s": self.percentile(50), "p99_s": self.percentile(99)}


class RollingMeter:
    """Rolling event rate over a sliding window (default 1 s): ``rate()``
    is events-in-window / window, i.e. instantaneous QPS."""

    def __init__(self, window_s: float = 1.0):
        self.window_s = window_s
        self._stamps: collections.deque = collections.deque()
        self.total = 0

    def tick(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        for _ in range(n):
            self._stamps.append(now)
        self.total += n
        self._evict(now)

    def _evict(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._stamps and self._stamps[0] < cutoff:
            self._stamps.popleft()

    def rate(self, now: Optional[float] = None) -> float:
        now = time.perf_counter() if now is None else now
        self._evict(now)
        return len(self._stamps) / self.window_s


class ServeStats:
    """Everything the serving tier records, in one bag.

    ``ContinuousBatcher.step()`` feeds it per launch: finished-ticket
    latencies into three histograms (total / queue / service), completions
    into the QPS meter, pre-admission queue depth, and (under DRR) the
    per-client deficit vector. ``snapshot()`` is the JSON-ready summary.
    """

    def __init__(self, window_s: float = 1.0):
        self.latency = LatencyHistogram()
        self.queue = LatencyHistogram()
        self.service = LatencyHistogram()
        self.qps = RollingMeter(window_s)
        self.queue_depth: List[int] = []
        self.deficit_snaps: List[List[float]] = []
        self.launches = 0

    def record_ticket(self, ticket) -> None:
        self.latency.record(ticket.latency)
        self.queue.record(ticket.queue_s)
        self.service.record(ticket.service_s)
        self.qps.tick()

    def record_launch(self, depth: int, deficit=None) -> None:
        self.launches += 1
        self.queue_depth.append(int(depth))
        if deficit is not None:
            self.deficit_snaps.append(np.asarray(deficit, np.float64).tolist())

    def snapshot(self) -> Dict[str, Any]:
        depth = np.asarray(self.queue_depth, np.float64)
        out = {
            "latency": self.latency.snapshot(),
            "queue": self.queue.snapshot(),
            "service": self.service.snapshot(),
            "qps_now": self.qps.rate(),
            "completed": int(self.qps.total),
            "launches": int(self.launches),
            "queue_depth": {
                "mean": float(depth.mean()) if depth.size else float("nan"),
                "max": int(depth.max()) if depth.size else 0,
            },
        }
        if self.deficit_snaps:
            last = np.asarray(self.deficit_snaps[-1])
            out["drr_deficit_last"] = last.tolist()
            out["drr_deficit_spread"] = float(last.max() - last.min())
        return out
