"""Federated lifelong simulation driver (paper §V protocol).

The port of ``run_simulation`` of ``repro/federated/simulation.py``: C edge
clients x T sequential tasks x R rounds (R/T rounds per task, ``epochs``
local epochs per round; the paper trains 60 rounds over 6 tasks). Each
round: local training -> upload -> server integration -> dispatch -> every
``eval_every`` rounds the retrieval evaluation (mAP/CMC, Eq. 7) and
forgetting (Eq. 8), with the reference's S2C/C2S byte accounting. Two
engines drive the rounds:

  * ``engine="host"`` (the default, as in the reference): one client at a
    time, per-client states, the server round over host lists of heads;
    every strategy runs here.
  * ``engine="stacked"``: strategies with ``supports_stacked`` keep all C
    clients as one (C, ...) state, gather the round's minibatches up front
    (the host engine's rng draw order, so both train on the same batches)
    and train, serve and dispatch for all C at once.
  * ``engine="sharded"``: the stacked round over the ranks of a
    ``torch.distributed`` world (NCCL on the card, gloo on the CPU; the
    default group under ``torchrun``, else a world of one). C is padded to
    Cp, a multiple of the ranks (``sharding.specs.padded_clients``), and
    each rank holds its block of the Cp rows of the state, the minibatches
    and the evaluation inputs; the padding rows train on the last client's
    data and are masked out of the relevance ring. Every rank draws the
    minibatches and keeps the rehearsal memories and the lifelong tracker
    of all C clients, so the one rng stream stays the reference's. The
    server gathers the task features and forms Eq. 6 as per-rank partial
    products and one reduce-scatter (``core.fedstil``); a codec encodes
    each rank's rows; the evaluation gathers the (Cp, T) metrics. Bytes
    count the C real clients; every rank returns the same result. Rank 0
    alone traces.

A strategy with wire codecs (``FedSTIL(..., codec="topk+int8")``) sends the
upload and the dispatch through them (the host codec one client at a time
on the host engine, inside local training and the apply;
``comm.batched.BatchedCodec`` over all C rows on the stacked one) and logs
the measured wire bytes beside the formulas
(``SimulationResult.comm_breakdown()``). Evaluation runs batched on the
device (``eval_backend="device"``: every client's heads stacked, one pass)
or, with ``"host"``, one client and task at a time through the numpy
oracle (``evalreid.evaluate_retrieval``).

Prototypes are extracted once up front (the extraction layers are frozen),
and the evaluation inputs are cached: the (C, T, Q, D) query stacks stay on
the device, and each task's (C, G_max, D) galleries are assembled once from
the pre-extracted query prototypes of the other clients.

``run_simulation(..., trace=...)`` traces a run (``repro_torch.obs``): the
reference's phase spans (``round.gather`` / ``local_train`` / ``encode`` /
``server`` / ``apply`` / ``eval``), the server's stage spans, the codec
spans and the relevance and encode metrics, each span ending in a device
sync where the reference's does. ``SimulationResult.stage_ms`` is filled
from those spans. Untraced, every hook is the null tracer's: no device
syncs, no metric launches, no readbacks, and ``stage_ms`` stays empty.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.accounting import CommLog
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_map, tree_slice
from repro_torch.core import edge_model as EM
from repro_torch.data.synthetic import FederatedReIDBenchmark
from repro_torch.evalreid.batched import max_match_bound
from repro_torch.evalreid.retrieval import evaluate_retrieval
from repro_torch.federated.base import (Strategy, eval_round_stacked,
                                        forward_one, place_client_rows,
                                        sharded_eval)
from repro_torch.obs import trace as obs
from repro_torch.sharding import specs as shard_specs
from repro_torch.train.metrics import LifelongTracker

EVAL_RANKS = (1, 3, 5)
ENGINES = ("host", "stacked", "sharded")


@dataclasses.dataclass
class SimulationResult:
    name: str
    tracker: LifelongTracker
    comm: CommLog
    storage_bytes: int
    rounds: List[Dict[str, float]]      # per-eval-round mean metrics
    server_time_s: float = 0.0          # wall time inside the server round
    # traced runs only: per round, its wall and each stage's summed span ms
    stage_ms: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    # the run's evaluation galleries, to serve (RetrievalEngine.from_eval_cache)
    eval_cache: Optional["_EvalCache"] = None

    def final(self, key="mAP") -> float:
        return self.rounds[-1][key] if self.rounds else 0.0

    def final_metrics(self) -> Dict[str, float]:
        return self.rounds[-1] if self.rounds else {}

    def comm_breakdown(self) -> List[Dict[str, int]]:
        return self.comm.round_breakdown()


def _pre_extract_prototypes(bench: FederatedReIDBenchmark, g_params, device):
    """Every task's train and query prototypes, computed once (the
    extraction layers are frozen): one batched pass over the stacked
    (C T, N, img_dim) images when every task has the same shapes (the
    benchmark's default), task by task otherwise. Returns {(client, task):
    (train protos, train labels, query protos, query labels)}, numpy (fp32
    prototypes)."""
    tasks = [bench.task(c, t) for c in range(bench.n_clients)
             for t in range(bench.n_tasks)]

    def extract(x):
        with torch.no_grad():
            return EM.extract_prototypes(
                g_params, torch.from_numpy(x).to(device)).cpu().numpy()

    if len({(task.train_x.shape, task.query_x.shape) for task in tasks}) > 1:
        return {(task.client, task.round): (
            extract(task.train_x), task.train_y, extract(task.query_x),
            task.query_y) for task in tasks}
    n_train = tasks[0].train_x.shape[0]
    out = extract(np.stack([np.concatenate([task.train_x, task.query_x])
                            for task in tasks]))
    return {(task.client, task.round): (out[i, :n_train], task.train_y,
                                        out[i, n_train:], task.query_y)
            for i, task in enumerate(tasks)}


class _EvalCache:
    """Evaluation inputs, built once per simulation: each (client, task)'s
    host gallery, and for the batched evaluation (``stacks``, when every
    query set has one shape) the (C, T, Q, D) query stacks and their ids on
    the device, the match bound, and each task's padded (C, G_max, D)
    galleries (G_max = the last task's gallery size, so the shapes never
    change; galleries of past tasks are dropped as t advances)."""

    def __init__(self, bench: FederatedReIDBenchmark, protos, device,
                 stacks: bool = True):
        self.bench = bench
        self.protos = protos
        self.device = device
        C, T = bench.n_clients, bench.n_tasks
        self.mesh: Optional[shard_specs.EngineMesh] = None
        self._padded: Optional[int] = None
        self._dev_t: Optional[int] = None
        self._dev_gal: Optional[Tuple[torch.Tensor, ...]] = None
        self._host_gal: Dict[Tuple[int, int], Tuple[np.ndarray, ...]] = {}
        qshapes = {protos[(c, t)][2].shape for c in range(C) for t in range(T)}
        # a ragged benchmark cannot be stacked: it evaluates on the host
        self.device_ready = stacks and len(qshapes) == 1
        if not self.device_ready:
            return
        qp = np.stack([np.stack([protos[(c, t)][2] for t in range(T)])
                       for c in range(C)]).astype(np.float32)
        qids = np.stack([np.stack([protos[(c, t)][3] for t in range(T)])
                         for c in range(C)]).astype(np.int64)
        self.qp = torch.from_numpy(qp).to(device)              # (C, T, Q, D)
        self.qids = torch.from_numpy(qids).to(device)          # (C, T, Q)
        self.g_max = sum(protos[k][2].shape[0]
                         for k in bench.gallery_members(0, T - 1))
        # the largest (t = T-1) galleries bound every earlier task's
        self.max_matches = max(
            max_match_bound(qids[c][None], np.concatenate(
                [protos[k][3] for k in bench.gallery_members(c, T - 1)])[None])
            for c in range(C))

    def place(self, mesh, padded: int):
        """The sharded engine: every stacked input's client dim padded to
        Cp (the last client's row repeated: padding rows are evaluated and
        never read) and cut to this rank's block. ``max_matches`` stays the
        bound over all C clients."""
        if not self.device_ready:
            return
        self.mesh, self._padded = mesh, padded
        self.qp = self._rows(self.qp)
        self.qids = self._rows(self.qids)
        self._dev_t = None

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        return place_client_rows(t, self.mesh, self._padded, self.device)

    def host_gallery(self, c: int, t: int):
        """(gallery prototypes, ids) of client c at task t: the other
        clients' query splits of tasks <= t, built once per (c, t)."""
        key = (c, t)
        if key not in self._host_gal:
            if self._host_gal and next(iter(self._host_gal))[1] != t:
                self._host_gal.clear()       # t is monotone: drop old tasks
            members = self.bench.gallery_members(c, t)
            self._host_gal[key] = (
                np.concatenate([self.protos[k][2] for k in members]),
                np.concatenate([self.protos[k][3] for k in members]))
        return self._host_gal[key]

    def device_gallery(self, t: int):
        """(C, G_max, D) prototypes, (C, G_max) ids (-1 = padding) and
        (C, G_max) validity for task t, on the device."""
        if self._dev_t != t:
            C = self.bench.n_clients
            D = self.qp.shape[-1]
            gp = np.zeros((C, self.g_max, D), np.float32)
            gids = np.full((C, self.g_max), -1, np.int64)
            gmask = np.zeros((C, self.g_max), np.float32)
            for c in range(C):
                p, y = self.host_gallery(c, t)
                gp[c, :len(p)] = p
                gids[c, :len(y)] = y
                gmask[c, :len(p)] = 1.0
            self._dev_t = t
            self._dev_gal = tuple(self._rows(torch.from_numpy(a).to(
                self.device)) for a in (gp, gids, gmask))
        return self._dev_gal

    def task_mask(self, t: int) -> torch.Tensor:
        C, T = self.bench.n_clients, self.bench.n_tasks
        m = torch.zeros((C, T), device=self.device)
        m[:, :t + 1] = 1.0
        return self._rows(m)


def _round_summary(tracker, rnd):
    per_round = {"round": rnd}
    for key in ("mAP",) + tuple(f"R{k}" for k in EVAL_RANKS):
        per_round[key] = tracker.mean_accuracy(rnd, key)
    per_round["forgetting_mAP"] = tracker.mean_forgetting(rnd, "mAP")
    per_round["forgetting_R1"] = tracker.mean_forgetting(rnd, "R1")
    return per_round


def _eval_round(features, cache, tracker, rnd, t):
    """The host evaluation (Eq. 7/8), the oracle: per client and trained
    task, features on the card (``features(c, protos)``, client c's head on
    host prototypes) and the numpy retrieval metrics."""
    for c in range(cache.bench.n_clients):
        gal_p, gal_y = cache.host_gallery(c, t)
        gal_f = features(c, gal_p)
        for tt in range(t + 1):
            _, _, qx, qy = cache.protos[(c, tt)]
            qf = features(c, qx)
            m = evaluate_retrieval(qf, qy, gal_f, gal_y, ranks=EVAL_RANKS)
            tracker.record(c, tt, rnd, m)
    return _round_summary(tracker, rnd)


def _eval_round_device(theta_stacked, cache, tracker, rnd, t):
    """Every (client, trained task) mAP/CMC in one batched pass; only the
    (C, T) metrics come back to feed the lifelong tracker (Eq. 8)."""
    gp, gids, gmask = cache.device_gallery(t)
    args = (theta_stacked, cache.qp, cache.qids, cache.task_mask(t), gp,
            gids, gmask)
    kw = dict(ranks=EVAL_RANKS, max_matches=cache.max_matches)
    out = (eval_round_stacked(*args, **kw) if cache.mesh is None
           else sharded_eval(cache.mesh, *args, **kw))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    for c in range(cache.bench.n_clients):
        for tt in range(t + 1):
            tracker.record(c, tt, rnd, {k: float(out[k][c, tt]) for k in out})
    return _round_summary(tracker, rnd)


def _initial_params(strategy, bench, seed, device, init_params):
    """(extraction params, per-client initial heads) on ``device``: drawn
    from a CPU torch generator seeded with ``seed`` (so one seed gives the
    same weights on the card and on the CPU), or carried from
    ``init_params`` (``core.convert.init_params_from_jax``)."""
    C = bench.n_clients
    if init_params is None:
        gen = torch.Generator().manual_seed(seed)
        init_params = {
            "extraction": EM.init_extraction(strategy.cfg, gen),
            "theta0": [EM.init_adaptive_layers(strategy.cfg, gen)
                       for _ in range(C)]}
    if len(init_params["theta0"]) != C:
        raise ValueError(f"init_params carries {len(init_params['theta0'])} "
                         f"heads for {C} clients")
    to = lambda tree: {k: torch.as_tensor(np.asarray(v)).to(device)
                       for k, v in tree.items()}
    return to(init_params["extraction"]), [to(t) for t in
                                           init_params["theta0"]]


@dataclasses.dataclass
class _Run:
    """What both engines' round loops share."""

    strategy: Strategy
    bench: FederatedReIDBenchmark
    protos: dict
    cache: _EvalCache
    g_params: dict
    device: torch.device
    rounds: int
    eval_every: int
    verbose: bool
    tracker: LifelongTracker
    comm: CommLog = dataclasses.field(default_factory=CommLog)
    eval_rounds: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)
    wall_ms: List[float] = dataclasses.field(default_factory=list)
    server_s: float = 0.0

    @property
    def rounds_per_task(self) -> int:
        return max(1, self.rounds // self.bench.n_tasks)

    def task(self, rnd: int) -> int:
        return min(rnd // self.rounds_per_task, self.bench.n_tasks - 1)

    def evaluate(self, rnd, t, stacked_theta, features, engine):
        """The round's evaluation when it is due: batched on the device
        (``stacked_theta()``) or per client on the host (``features(c,
        protos)``)."""
        if (rnd + 1) % self.eval_every and rnd != self.rounds - 1:
            return
        with obs.span("round.eval", cat="phase", round=rnd):
            if self.cache.device_ready:
                per_round = _eval_round_device(stacked_theta(), self.cache,
                                               self.tracker, rnd, t)
            else:
                per_round = _eval_round(features, self.cache, self.tracker,
                                        rnd, t)
        self.eval_rounds.append(per_round)
        if self.verbose:
            print(f"  [{self.strategy.name}/{engine}/{self.device.type}] "
                  f"round {rnd}: mAP={per_round['mAP']:.4f} "
                  f"R1={per_round['R1']:.4f} "
                  f"F={per_round['forgetting_mAP']:.4f}")


def run_simulation(strategy: Strategy, bench: FederatedReIDBenchmark, *,
                   rounds: int = 12, eval_every: int = 2, seed: int = 0,
                   verbose: bool = False, engine: str = "host",
                   eval_backend: str = "device", device="cuda",
                   init_params: Optional[dict] = None,
                   trace=None) -> SimulationResult:
    """Drive ``rounds`` federated rounds of ``strategy`` over ``bench`` on
    ``device`` (the card by default; ``"cpu"`` runs the plain versions).

    ``engine``: ``"host"`` (the default, as in the reference),
    ``"stacked"`` (strategies with ``supports_stacked``) or ``"sharded"``
    (the stacked round over the ranks of the ``torch.distributed`` world:
    the initialized default group, whose rank ``device="cuda"`` runs on
    ``cuda:LOCAL_RANK``, else a world of one; rank 0 alone traces, the
    others run the null tracer). ``eval_backend``: ``"device"`` (batched) or
    ``"host"`` (per client, the numpy oracle). ``init_params`` =
    {"extraction": {"w1", "w2"}, "theta0": [C flat head dicts]} of numpy
    arrays starts from given weights instead of a CPU torch generator
    seeded with ``seed`` (the reference draws from ``jax.random``, which
    torch cannot reproduce).

    ``trace`` turns on telemetry for this run: a path writes the JSONL
    there (summarize with ``python -m repro_torch.obs.report``); an
    ``obs.Tracer`` records into it without closing (the caller owns the
    sink). ``None`` (default) keeps every obs hook on the active tracer,
    the null one unless the caller activated another — no timestamps, no
    device syncs, no readbacks.
    """
    kw = dict(rounds=rounds, eval_every=eval_every, seed=seed,
              verbose=verbose, engine=engine, eval_backend=eval_backend,
              device=device, init_params=init_params)
    if engine != "sharded":
        return _traced(strategy, bench, trace, kw)
    with shard_specs.engine_world(device) as dev:
        kw["device"] = dev
        if dist.get_rank() == 0:
            return _traced(strategy, bench, trace, kw)
        with obs.suspended():
            return _run_simulation(strategy, bench, **kw)


def _traced(strategy, bench, trace, kw):
    """``_run_simulation`` under the tracer ``trace`` asks for (None: the
    active one)."""
    if trace is None:
        return _run_simulation(strategy, bench, **kw)
    owns = not isinstance(trace, obs.Tracer)
    tracer = obs.Tracer(trace) if owns else trace
    tracer.meta(kind_detail="run_simulation", engine=kw["engine"],
                rounds=kw["rounds"], n_clients=bench.n_clients,
                strategy=strategy.name)
    try:
        with obs.active(tracer):
            return _run_simulation(strategy, bench, **kw)
    finally:
        if owns:
            tracer.close()


def _run_simulation(strategy, bench, *, rounds, eval_every, seed, verbose,
                    engine, eval_backend, device, init_params):
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if eval_backend not in ("device", "host"):
        raise ValueError(f"unknown eval_backend {eval_backend!r}")
    if engine != "host" and not strategy.supports_stacked:
        raise ValueError(f"strategy {strategy.name!r} does not implement the "
                         "stacked engine API; use engine='host'")
    dev = resolve_device(device)
    tracer = obs.get_tracer()
    first_event = len(tracer.events) if tracer.active else 0
    g_params, thetas0 = _initial_params(strategy, bench, seed, dev,
                                        init_params)
    states = {c: strategy.init_client(thetas0[c])
              for c in range(bench.n_clients)}
    protos = _pre_extract_prototypes(bench, g_params, dev)
    run = _Run(strategy, bench, protos,
               _EvalCache(bench, protos, dev, eval_backend == "device"),
               g_params, dev, rounds, eval_every, verbose,
               LifelongTracker(bench.n_clients))
    if engine == "host":
        storage = _host_rounds(run, states)
    elif engine == "stacked":
        storage = _stacked_rounds(run, states)
    else:
        # the run's mesh: its groups go when the run ends, the world stays
        with shard_specs.engine_mesh(device=dev) as mesh:
            try:
                storage = _stacked_rounds(run, states, mesh)
            finally:
                strategy.mesh = None
    stage_ms = (_stage_ms(tracer.events[first_event:], run.wall_ms)
                if tracer.active else [])
    return SimulationResult(strategy.name, run.tracker, run.comm, storage,
                            run.eval_rounds, server_time_s=run.server_s,
                            stage_ms=stage_ms, eval_cache=run.cache)


# the phase spans' stage_ms keys (round.encode's time is in its codec spans)
PHASE_STAGES = {"round.gather": "gather", "round.local_train": "local_train",
                "round.server": "server", "round.apply": "apply",
                "round.eval": "eval"}
CODEC_STAGES = {"comm.upload": "encode_c2s", "comm.dispatch": "encode_s2c",
                "c2s": "encode_c2s", "s2c": "encode_s2c"}


def _stage_ms(events, wall_ms):
    """A traced run's spans -> per round {"round", "wall_ms", stage: ms}:
    the phase spans under their stage names, the server's stage spans under
    their own (``server.relevance``, ...), and the codec spans summed per
    direction (``encode_c2s`` / ``encode_s2c``). A codec span carries no
    round; it belongs to the phase span that encloses it, the next one to
    end."""
    rows = [{"round": rnd, "wall_ms": w} for rnd, w in enumerate(wall_ms)]
    pending: List[Tuple[str, float]] = []
    for e in events:
        if e["kind"] != "span":
            continue
        name, ms = e["name"], e["dur"] * 1e3
        if e.get("cat") == "codec":
            pending.append((CODEC_STAGES[e["peer"][0] if "peer" in e
                                         else name], ms))
            continue
        row = rows[e["round"]]
        key = PHASE_STAGES.get(name, name if e.get("cat") == "stage"
                               else None)
        for k, v in pending + ([(key, ms)] if key else []):
            row[k] = row.get(k, 0.0) + v
        pending.clear()
    return rows


def _host_rounds(run: _Run, states) -> int:
    """The host engine: every round trains the clients one by one, sending
    each upload through the upload codec when there is one, runs the server
    over the uploads and applies each non-empty dispatch (through the
    dispatch codec). Returns the largest client storage."""
    strategy, C = run.strategy, run.bench.n_clients
    accepts_raw = "raw_images" in inspect.signature(
        strategy.local_train).parameters
    for rnd in range(run.rounds):
        t = run.task(rnd)
        t_round = time.perf_counter()
        # EWC/MAS-style methods consolidate importance at task boundaries
        consolidate = ((rnd + 1) % run.rounds_per_task == 0
                       or rnd == run.rounds - 1)
        uploads = {}
        with obs.span("round.local_train", cat="phase", round=rnd):
            for c in range(C):
                px, py, _, _ = run.protos[(c, t)]
                kw = {"consolidate": consolidate}
                if accepts_raw:
                    kw.update(raw_images=run.bench.task(c, t).train_x,
                              g_params=run.g_params)
                states[c], up = strategy.local_train(c, states[c], px, py,
                                                     rnd, **kw)
                if up is None:
                    continue
                formula = strategy.upload_bytes(up)
                if strategy.upload_codec is not None:
                    # the server integrates the DECODED (possibly lossy)
                    # upload
                    up, measured = strategy.wire_upload(up, c)
                    run.comm.log_c2s(rnd, formula, measured=measured)
                else:
                    run.comm.log_c2s(rnd, formula)
                uploads[c] = up

        if strategy.uses_server and uploads:
            t0 = time.perf_counter()
            with obs.span("round.server", cat="phase", round=rnd):
                dispatches = strategy.server_round(rnd, uploads)
            run.server_s += time.perf_counter() - t0
            with obs.span("round.apply", cat="phase", round=rnd):
                for c, d in dispatches.items():
                    if not d:
                        continue
                    formula = strategy.dispatch_bytes(d)
                    if strategy.dispatch_codec is not None:
                        d, measured = strategy.wire_dispatch(d, c)
                        run.comm.log_s2c(rnd, formula, measured=measured)
                    else:
                        run.comm.log_s2c(rnd, formula)
                    states[c] = strategy.apply_dispatch(states[c], d)

        run.evaluate(rnd, t, lambda: strategy.stack_eval_thetas(states),
                     lambda c, p: strategy.features(states[c], p), "host")
        run.wall_ms.append((time.perf_counter() - t_round) * 1e3)
    return max(strategy.storage_bytes(states[c]) for c in range(C))


def _stacked_rounds(run: _Run, states, mesh=None) -> int:
    """The stacked engine: every round gathers all clients' minibatches,
    trains them at once, and runs the upload codec, the server, the
    dispatch codec and the dispatch over all C rows. With ``mesh`` (the
    sharded engine) the same over this rank's block of the Cp padded rows:
    the formulas are per row, the counts the C real clients', the
    dispatches with relevant neighbours and the storage gathered over the
    ranks. Returns the largest client storage."""
    strategy, C, dev = run.strategy, run.bench.n_clients, run.device
    stacked = strategy.stack_states(states)
    valid, rows = None, C                   # this rank's rows
    if mesh is not None:
        stacked, valid = strategy.shard_stacked_state(stacked, mesh)
        run.cache.place(mesh, strategy.padded_clients)
        rows = strategy.padded_clients // mesh.size("data")
    lo = stacked.row0
    for rnd in range(run.rounds):
        t = run.task(rnd)
        t_round = time.perf_counter()
        protos_list = [run.protos[(c, t)][0] for c in range(C)]
        labels_list = [run.protos[(c, t)][1] for c in range(C)]
        with obs.span("round.gather", cat="phase", round=rnd):
            bx, by = strategy.gather_round_batches(stacked, protos_list,
                                                   labels_list, dev)
        with obs.span("round.local_train", cat="phase", round=rnd) as sp:
            stacked, upload = strategy.local_train_stacked(
                stacked, bx, by, protos_list, labels_list, rnd)
            sp.sync(stacked.trainable)
        if upload is not None:
            formula = strategy.stacked_upload_bytes(upload, rows)
            if strategy.upload_codec is not None:
                # one batched encode + decode of all C rows; the server
                # round consumes the decoded (lossy) upload
                with obs.span("round.encode", cat="phase", round=rnd):
                    upload, measured = strategy.wire_upload_stacked(upload)
                run.comm.log_c2s_many(rnd, formula, C, measured=measured)
            else:
                run.comm.log_c2s_many(rnd, formula, C)

        if strategy.uses_server and upload is not None:
            t0 = time.perf_counter()
            with obs.span("round.server", cat="phase", round=rnd) as sp:
                dispatch = strategy.server_round_stacked(rnd, upload,
                                                         valid=valid)
                if dispatch is not None:
                    sp.sync(dispatch)
            run.server_s += time.perf_counter() - t0
            if dispatch is not None:
                per_client = strategy.stacked_dispatch_bytes(dispatch, rows)
                n_nz = C
                if "nz" in dispatch:
                    # padding rows never have relevant neighbours
                    n_nz = torch.sum(dispatch["nz"])
                    n_nz = int(n_nz if mesh is None else mesh.all_sum(n_nz))
                if strategy.dispatch_codec is not None:
                    # the stacked wire model is a BROADCAST stream: all C
                    # rows are encoded (and the delta references advance)
                    # every dispatch round, so all C are shipped and
                    # counted; the formula keeps one dispatch per client
                    # with relevant neighbours
                    with obs.span("round.encode", cat="phase", round=rnd):
                        dispatch, measured = strategy.wire_dispatch_stacked(
                            dispatch)
                    run.comm.log_s2c_many(rnd, per_client, C,
                                          measured=measured, n_formula=n_nz)
                else:
                    run.comm.log_s2c_many(rnd, per_client, n_nz)
                with obs.span("round.apply", cat="phase", round=rnd) as sp:
                    stacked = strategy.apply_dispatch_stacked(stacked,
                                                              dispatch)
                    sp.sync(stacked.extras)

        run.evaluate(rnd, t, lambda: strategy.eval_theta_stacked(stacked),
                     _stacked_features(strategy, stacked, mesh), "stacked"
                     if mesh is None else "sharded")
        run.wall_ms.append((time.perf_counter() - t_round) * 1e3)
    mine = range(lo, min(lo + rows, C))
    storage = max([strategy.storage_bytes(strategy.client_view(stacked, c))
                   for c in mine] or [0])
    return storage if mesh is None else mesh.all_max(storage)


def _stacked_features(strategy, stacked, mesh):
    """``features(c, protos)`` of the host evaluation on a stacked state;
    on the sharded engine every rank's eval-time heads are gathered first
    (once per evaluation, when it runs)."""
    if mesh is None:
        return lambda c, p: strategy.features(strategy.client_view(stacked,
                                                                   c), p)
    gathered = {}

    def features(c, protos):
        if not gathered:
            gathered.update(tree_map(mesh.all_gather_rows,
                                     strategy.eval_theta_stacked(stacked)))
        return forward_one(tree_slice(gathered, c), protos)
    return features
