"""Continuous batching front end for the retrieval engine (a copy of
``repro/serving/batcher.py``, host-side numpy; each launch is traced as a
``serve.batch`` span when a tracer is active).

Queries arrive one at a time, tagged with a client; the batcher coalesces
them into the engine's fixed-shape (C, B, proto_dim) batches — padding +
validity masks — so every launch amortizes dispatch over up to C*B queries.
Because the featurization uses frozen BN statistics, a query's answer is
independent of whichever batch it rides in: coalescing is a throughput
choice, never a semantics one.

Admission policy: by default every client independently drains oldest
first at up to B slots/step ("fifo"). When a shared ``step_budget`` caps
the total slots per launch, "fifo" serves clients in index order and a hot
client can starve the rest; ``policy="drr"`` switches to deficit round
robin — each backlogged client earns ``quantum`` slots of credit per step,
spends credit when served, and the rotation start advances every step, so
throughput per backlogged client converges to an equal share while
leftover slots still go to whoever has work (work conserving).

Latency accounting: a ``Ticket`` is stamped at submit and again when its
launch starts, so latency = queueing (``t_launch - t_submit``) + service
(``t_done - t_launch``, launch + readback).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import ServeStats


@dataclasses.dataclass
class Ticket:
    client: int
    qid: int
    t_submit: float
    t_launch: Optional[float] = None       # stamped when its launch starts
    t_done: Optional[float] = None
    ids: Optional[np.ndarray] = None       # (k,) top-k gallery ids
    dists: Optional[np.ndarray] = None     # (k,) squared distances

    @property
    def latency(self) -> float:
        if self.t_done is None:
            raise RuntimeError(
                f"ticket (client={self.client}, qid={self.qid}) is not "
                "completed yet — step()/drain() the batcher first")
        return self.t_done - self.t_submit

    @property
    def queue_s(self) -> float:
        """Time spent waiting for a batch slot."""
        if self.t_launch is None:
            raise RuntimeError(
                f"ticket (client={self.client}, qid={self.qid}) has not "
                "been launched yet — step()/drain() the batcher first")
        return self.t_launch - self.t_submit

    @property
    def service_s(self) -> float:
        """Launch + readback time of the batch it rode in."""
        if self.t_done is None:
            raise RuntimeError(
                f"ticket (client={self.client}, qid={self.qid}) is not "
                "completed yet — step()/drain() the batcher first")
        return self.t_done - self.t_launch


class ContinuousBatcher:
    """Coalesce a per-client query stream into fixed (C, B) batches.

    ``batch`` is the per-client slot budget B per launch; a launch fires
    whatever is queued (oldest first per client), padding the rest.
    ``step_budget`` (optional) caps TOTAL slots per launch across clients;
    ``policy`` picks how a scarce budget is split ("fifo" = client-index
    order, "drr" = deficit round robin with ``quantum`` slots of credit per
    backlogged client per step, default budget // n_clients).
    ``stats`` (a ``ServeStats``) records queue depth, latencies, QPS and
    the drr deficits per launch; ``None`` records nothing.
    """

    def __init__(self, engine, batch: int = 32, *, policy: str = "fifo",
                 step_budget: Optional[int] = None,
                 quantum: Optional[int] = None,
                 stats: Optional[ServeStats] = None):
        if policy not in ("fifo", "drr"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.engine = engine
        self.batch = batch
        self.policy = policy
        self.stats = stats
        C = engine.index.n_clients
        self.step_budget = (C * batch if step_budget is None
                            else min(step_budget, C * batch))
        self.quantum = (max(1, self.step_budget // C) if quantum is None
                        else quantum)
        Dp = engine.index.gp.shape[-1]
        self._queues = [deque() for _ in range(C)]
        self._deficit = np.zeros(C, np.int64)
        self._rr = 0                        # rotation start for drr
        self._qp = np.zeros((C, batch, Dp), np.float32)
        self._qmask = np.zeros((C, batch), np.float32)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues)

    def submit(self, client: int, proto: np.ndarray, qid: int = -1,
               now: Optional[float] = None) -> Ticket:
        t = Ticket(client=client, qid=qid,
                   t_submit=time.perf_counter() if now is None else now)
        self._queues[client].append((t, np.asarray(proto, np.float32)))
        return t

    def _admit(self) -> List[int]:
        """Slots granted per client this step, honoring policy + budget."""
        C = len(self._queues)
        want = [min(len(q), self.batch) for q in self._queues]
        grant = [0] * C
        left = self.step_budget
        order = [(self._rr + i) % C for i in range(C)]
        if self.policy == "drr":
            for c in range(C):
                # credit accrues only while backlogged; an idle client's
                # stale credit would otherwise burst-starve the others
                self._deficit[c] = (self._deficit[c] + self.quantum
                                    if want[c] else 0)
            for c in order:
                n = min(want[c], int(self._deficit[c]), left)
                grant[c] = n
                self._deficit[c] -= n
                left -= n
            self._rr = (self._rr + 1) % C
        else:
            order = range(C)
        # work conserving: leftover budget goes to remaining backlog in
        # order (fifo does all its granting here)
        for c in order:
            n = min(want[c] - grant[c], left)
            grant[c] += n
            left -= n
        return grant

    def step(self) -> List[Ticket]:
        """Run one coalesced launch over the admitted pending queries.
        Returns the tickets completed by this launch (empty when idle)."""
        depth = self.pending
        self._qp[:] = 0.0
        self._qmask[:] = 0.0
        grant = self._admit()
        taken: List[List[Ticket]] = []
        for c, q in enumerate(self._queues):
            row = []
            while q and len(row) < grant[c]:
                t, proto = q.popleft()
                self._qp[c, len(row)] = proto
                self._qmask[c, len(row)] = 1.0
                row.append(t)
            taken.append(row)
        if not any(taken):
            return []
        n_slots = sum(len(row) for row in taken)
        launch = time.perf_counter()
        with obs.span("serve.batch", cat="serve", slots=n_slots):
            # query_batch returns numpy: the readback IS the sync boundary
            ids, dists = self.engine.query_batch(self._qp, self._qmask)
        done = time.perf_counter()
        out = []
        for c, row in enumerate(taken):
            for b, t in enumerate(row):
                t.t_launch = launch
                t.t_done = done
                t.ids = ids[c, b]
                t.dists = dists[c, b]
                out.append(t)
        if self.stats is not None:
            self.stats.record_launch(
                depth, self._deficit if self.policy == "drr" else None)
            for t in out:
                self.stats.record_ticket(t)
        return out

    def drain(self) -> List[Ticket]:
        """Step until every pending query is answered."""
        out = []
        while self.pending:
            out.extend(self.step())
        return out


def _latency_stats(tickets) -> dict:
    lat = np.array([t.latency for t in tickets])
    que = np.array([t.queue_s for t in tickets])
    srv = np.array([t.service_s for t in tickets])
    return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "queue_p50_ms": float(np.percentile(que, 50) * 1e3),
            "queue_p99_ms": float(np.percentile(que, 99) * 1e3),
            "service_p50_ms": float(np.percentile(srv, 50) * 1e3),
            "service_p99_ms": float(np.percentile(srv, 99) * 1e3)}


def run_closed_loop(batcher: ContinuousBatcher, stream) -> dict:
    """Submit every (client, proto, qid) then drain: peak-throughput
    measurement (QPS) plus latency percentiles (queue/service split)."""
    t0 = time.perf_counter()
    for client, proto, qid in stream:
        batcher.submit(client, proto, qid)
    tickets = batcher.drain()
    wall = time.perf_counter() - t0
    return {"n": len(tickets), "wall_s": wall,
            "qps": len(tickets) / wall,
            **_latency_stats(tickets),
            "tickets": tickets}


def run_open_loop(batcher: ContinuousBatcher, stream, rate_qps: float) -> dict:
    """Paced arrivals at ``rate_qps`` (uniform spacing): the latency a
    client actually sees at that load — queueing + service.

    Tickets are stamped with their SCHEDULED arrival time, so reported
    latency includes any pacing slip (the pacer sleeps to the next
    deadline and submits every due arrival on wake)."""
    stream = list(stream)
    gap = 1.0 / rate_qps
    tickets = []
    t0 = time.perf_counter()
    i = 0
    while len(tickets) < len(stream):
        now = time.perf_counter()
        while i < len(stream) and t0 + i * gap <= now:
            client, proto, qid = stream[i]
            batcher.submit(client, proto, qid, now=t0 + i * gap)
            i += 1
        if batcher.pending:
            tickets.extend(batcher.step())
        elif i < len(stream):
            time.sleep(max(0.0, t0 + i * gap - time.perf_counter()))
    wall = time.perf_counter() - t0
    return {"n": len(tickets), "wall_s": wall, "rate_qps": rate_qps,
            "qps": len(tickets) / wall,
            **_latency_stats(tickets),
            "tickets": tickets}
