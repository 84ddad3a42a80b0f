"""Federated lifelong simulation driver (paper §V protocol) on the stacked
engine.

The port of ``run_simulation(..., engine="stacked", eval_backend="device")``
of ``repro/federated/simulation.py``: C edge clients x T sequential tasks x
R rounds (R/T rounds per task, ``epochs`` local epochs per round; the paper
trains 60 rounds over 6 tasks). Each round: gather minibatches -> local
training of all clients -> upload -> server integration -> dispatch ->
every ``eval_every`` rounds the batched retrieval evaluation (mAP/CMC,
Eq. 7) and forgetting (Eq. 8), with the reference's S2C/C2S byte
accounting. A strategy with wire codecs (``FedSTIL(..., codec=
"delta+topk")``) sends the upload and the dispatch through them (stages
``encode_c2s`` and ``encode_s2c``) and logs the measured wire bytes beside
the formulas (``SimulationResult.comm_breakdown()``).

Prototypes are extracted once up front (the extraction layers are frozen),
and the evaluation inputs are cached: the (C, T, Q, D) query stacks stay on
the device, and each task's (C, G_max, D) galleries are assembled once from
the pre-extracted query prototypes of the other clients.

Every stage of a round is bracketed by a device sync and timed on the host
clock (``SimulationResult.stage_ms``): the round already reads the (C, C)
relevance and the dispatch mask back every round, so the syncs add no
waiting the round did not have.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.accounting import CommLog
from repro_torch.common.device import StageTimes, resolve_device
from repro_torch.core import edge_model as EM
from repro_torch.data.synthetic import FederatedReIDBenchmark
from repro_torch.evalreid.batched import max_match_bound
from repro_torch.federated.base import (Strategy, eval_round_stacked,
                                        not_in_this_slice)
from repro_torch.train.metrics import LifelongTracker

EVAL_RANKS = (1, 3, 5)
ENGINES_LATER = {"host": "the host-engine slice (5)",
                 "sharded": "the scale-out slice (telemetry and scale-out)"}


@dataclasses.dataclass
class SimulationResult:
    name: str
    tracker: LifelongTracker
    comm: CommLog
    storage_bytes: int
    rounds: List[Dict[str, float]]      # per-eval-round mean metrics
    server_time_s: float = 0.0          # wall time inside the server round
    stage_ms: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    # the run's evaluation galleries, to serve (RetrievalEngine.from_eval_cache)
    eval_cache: Optional["_EvalCache"] = None

    def final(self, key="mAP") -> float:
        return self.rounds[-1][key] if self.rounds else 0.0

    def final_metrics(self) -> Dict[str, float]:
        return self.rounds[-1] if self.rounds else {}

    def comm_breakdown(self) -> List[Dict[str, int]]:
        return self.comm.round_breakdown()


def _uniform(bench: FederatedReIDBenchmark):
    tasks = [bench.task(c, t) for c in range(bench.n_clients)
             for t in range(bench.n_tasks)]
    if len({(task.train_x.shape, task.query_x.shape) for task in tasks}) > 1:
        raise not_in_this_slice(
            "a benchmark with ragged task shapes (evaluated on the host)",
            "the host-engine slice (5)")
    return tasks


def _pre_extract_prototypes(bench: FederatedReIDBenchmark, g_params, device):
    """Every task's train and query prototypes, computed once in one
    batched pass over the stacked (C T, N, img_dim) images. Returns
    {(client, task): (train protos, train labels, query protos, query
    labels)}, numpy (fp32 prototypes, int64 labels)."""
    tasks = _uniform(bench)
    n_train = tasks[0].train_x.shape[0]
    stacked = np.stack([np.concatenate([task.train_x, task.query_x])
                        for task in tasks])
    with torch.no_grad():
        out = EM.extract_prototypes(
            g_params, torch.from_numpy(stacked).to(device)).cpu().numpy()
    return {(task.client, task.round): (out[i, :n_train], task.train_y,
                                        out[i, n_train:], task.query_y)
            for i, task in enumerate(tasks)}


class _EvalCache:
    """Evaluation inputs, built once per simulation: the (C, T, Q, D) query
    stacks and their ids on the device, the match bound, and each task's
    padded (C, G_max, D) galleries (G_max = the last task's gallery size,
    so the shapes never change; galleries of past tasks are dropped as t
    advances)."""

    def __init__(self, bench: FederatedReIDBenchmark, protos, device):
        self.bench = bench
        self.protos = protos
        self.device = device
        C, T = bench.n_clients, bench.n_tasks
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
        self._dev_t: Optional[int] = None
        self._dev_gal: Optional[Tuple[torch.Tensor, ...]] = None

    def host_gallery(self, c: int, t: int):
        """(gallery prototypes, ids) of client c at task t: the other
        clients' query splits of tasks <= t."""
        members = self.bench.gallery_members(c, t)
        return (np.concatenate([self.protos[k][2] for k in members]),
                np.concatenate([self.protos[k][3] for k in members]))

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
            self._dev_gal = tuple(torch.from_numpy(a).to(self.device)
                                  for a in (gp, gids, gmask))
        return self._dev_gal

    def task_mask(self, t: int) -> torch.Tensor:
        C, T = self.bench.n_clients, self.bench.n_tasks
        m = torch.zeros((C, T), device=self.device)
        m[:, :t + 1] = 1.0
        return m


def _round_summary(tracker, rnd):
    per_round = {"round": rnd}
    for key in ("mAP",) + tuple(f"R{k}" for k in EVAL_RANKS):
        per_round[key] = tracker.mean_accuracy(rnd, key)
    per_round["forgetting_mAP"] = tracker.mean_forgetting(rnd, "mAP")
    per_round["forgetting_R1"] = tracker.mean_forgetting(rnd, "R1")
    return per_round


def _eval_round_device(theta_stacked, cache, tracker, rnd, t):
    """Every (client, trained task) mAP/CMC in one batched pass; only the
    (C, T) metrics come back to feed the lifelong tracker (Eq. 8)."""
    gp, gids, gmask = cache.device_gallery(t)
    out = eval_round_stacked(
        theta_stacked, cache.qp, cache.qids, cache.task_mask(t), gp, gids,
        gmask, ranks=EVAL_RANKS, max_matches=cache.max_matches)
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


def run_simulation(strategy: Strategy, bench: FederatedReIDBenchmark, *,
                   rounds: int = 12, eval_every: int = 2, seed: int = 0,
                   verbose: bool = False, engine: str = "stacked",
                   eval_backend: str = "device", device="cuda",
                   init_params: Optional[dict] = None) -> SimulationResult:
    """Drive ``rounds`` federated rounds of ``strategy`` over ``bench`` on
    ``device`` (the card by default; ``"cpu"`` runs the plain versions).

    The engine is the stacked one (the only one ported); ``"host"`` and
    ``"sharded"`` raise NotImplementedError, as does ``eval_backend="host"``.
    ``init_params`` = {"extraction": {"w1", "w2"}, "theta0": [C flat head
    dicts]} of numpy arrays starts from given weights instead of a CPU
    torch generator seeded with ``seed`` (the reference draws from
    ``jax.random``, which torch cannot reproduce).
    """
    if engine in ENGINES_LATER:
        raise not_in_this_slice(f"engine={engine!r}", ENGINES_LATER[engine])
    if engine != "stacked":
        raise ValueError(f"unknown engine {engine!r}")
    if eval_backend == "host":
        raise not_in_this_slice("eval_backend='host'",
                                "the host-engine slice (5)")
    if eval_backend != "device":
        raise ValueError(f"unknown eval_backend {eval_backend!r}")
    if not strategy.supports_stacked:
        raise ValueError(f"strategy {strategy.name!r} does not implement the "
                         "stacked engine API")
    dev = resolve_device(device)

    C, T = bench.n_clients, bench.n_tasks
    rounds_per_task = max(1, rounds // T)
    g_params, thetas0 = _initial_params(strategy, bench, seed, dev,
                                        init_params)
    states = {c: strategy.init_client(thetas0[c]) for c in range(C)}
    tracker = LifelongTracker(C)
    comm = CommLog()
    eval_rounds: List[Dict[str, float]] = []
    stage_ms: List[Dict[str, float]] = []
    server_s = 0.0

    protos = _pre_extract_prototypes(bench, g_params, dev)
    cache = _EvalCache(bench, protos, dev)
    stacked = strategy.stack_states(states)

    for rnd in range(rounds):
        t = min(rnd // rounds_per_task, T - 1)
        clock = StageTimes(dev)
        t_round = time.perf_counter()
        protos_list = [protos[(c, t)][0] for c in range(C)]
        labels_list = [protos[(c, t)][1] for c in range(C)]
        with clock.stage("gather"):
            bx, by = strategy.gather_round_batches(stacked, protos_list,
                                                   labels_list, dev)
        with clock.stage("local_train"):
            stacked, upload = strategy.local_train_stacked(
                stacked, bx, by, protos_list, labels_list, rnd)
        if upload is not None:
            formula = strategy.stacked_upload_bytes(upload, C)
            if strategy.upload_codec is not None:
                # one batched encode + decode of all C rows; the server
                # round consumes the decoded (lossy) upload
                with clock.stage("encode_c2s"):
                    upload, measured = strategy.wire_upload_stacked(upload)
                comm.log_c2s_many(rnd, formula, C, measured=measured)
            else:
                comm.log_c2s_many(rnd, formula, C)

        if strategy.uses_server and upload is not None:
            t0 = time.perf_counter()
            with clock.stage("server"):
                dispatch = strategy.server_round_stacked(rnd, upload)
            server_s += time.perf_counter() - t0
            clock.update({f"server.{k}": v
                          for k, v in strategy.server_ms.items()})
            if dispatch is not None:
                per_client = strategy.stacked_dispatch_bytes(dispatch, C)
                n_nz = int(dispatch["nz"].sum())
                if strategy.dispatch_codec is not None:
                    # the stacked wire model is a BROADCAST stream: all C
                    # rows are encoded (and the delta references advance)
                    # every dispatch round, so all C are shipped and
                    # counted; the formula keeps one dispatch per client
                    # with relevant neighbours
                    with clock.stage("encode_s2c"):
                        dispatch, measured = strategy.wire_dispatch_stacked(
                            dispatch)
                    comm.log_s2c_many(rnd, per_client, C, measured=measured,
                                      n_formula=n_nz)
                else:
                    comm.log_s2c_many(rnd, per_client, n_nz)
                with clock.stage("apply"):
                    stacked = strategy.apply_dispatch_stacked(stacked,
                                                              dispatch)

        if (rnd + 1) % eval_every == 0 or rnd == rounds - 1:
            with clock.stage("eval"):
                per_round = _eval_round_device(
                    strategy.eval_theta_stacked(stacked), cache, tracker, rnd,
                    t)
            eval_rounds.append(per_round)
            if verbose:
                print(f"  [{strategy.name}/stacked/{dev.type}] round {rnd}: "
                      f"mAP={per_round['mAP']:.4f} R1={per_round['R1']:.4f} "
                      f"F={per_round['forgetting_mAP']:.4f}")
        stage_ms.append({"round": rnd,
                         "wall_ms": (time.perf_counter() - t_round) * 1e3,
                         **clock})

    storage = max(strategy.storage_bytes(strategy.client_view(stacked, c))
                  for c in range(C))
    return SimulationResult(strategy.name, tracker, comm, storage, eval_rounds,
                            server_time_s=server_s, stage_ms=stage_ms,
                            eval_cache=cache)
