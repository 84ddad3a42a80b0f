"""Rank-side halves of ``tests/test_torch_sharded.py``.

Each function here runs on every rank of a world that
``repro_torch.launch.mesh.spawn`` starts (gloo on the CPU) and returns a
picklable summary; the test process compares the summaries with the JAX
package. This module imports only the port, so a spawned rank does not
import JAX. Run as a script under ``torchrun`` it runs named scenarios on
torchrun's world:

    torchrun --standalone --nproc-per-node 2 tests/torch_sharded_workers.py \
        OUT.json fedstil_f32 fedavg
"""
import json
import os
import sys

import torch

from repro_torch.core.fedstil import FedSTIL, sharded_fused_aggregate
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated import FedAvg, FedProx, run_simulation
from repro_torch.launch import eval_round as ER
from repro_torch.launch import fed_round as FR
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.lifelong import STL
from repro_torch.obs import trace as obs
from repro_torch.sharding import specs as S

# C = 5, not a multiple of 2 or 4: Cp = 6 / 8, and on 4 ranks rank 3
# holds only padding. No identity of this bench has two training samples
# (the exemplar order of such an identity is rounding, ROADMAP Queue 3).
BENCH_KW = dict(n_clients=5, n_tasks=2, n_identities=40, ids_per_task=10,
                samples_per_id=10, seed=0)
RUN_KW = dict(rounds=4, eval_every=2)
STRATEGIES = {"fedstil": FedSTIL, "fedavg": FedAvg, "fedprox": FedProx,
              "stl": STL}
# name -> (strategy, its options, traced, the run's options)
SCENARIOS = {
    "fedstil_f32": ("fedstil", {"wire_dtype": "float32"}, False, {}),
    "fedstil_bf16": ("fedstil", {}, True, {}),
    "fedstil_int8": ("fedstil", {"wire_dtype": "float32",
                                 "codec": "topk+int8"}, False, {}),
    "fedstil_delta_topk": ("fedstil", {"wire_dtype": "float32",
                                       "codec": "delta+topk"}, False, {}),
    "fedstil_host_eval": ("fedstil", {"wire_dtype": "float32"}, False,
                          {"eval_backend": "host"}),
    "fedavg": ("fedavg", {}, False, {}),
    "fedprox": ("fedprox", {}, False, {}),
    "stl": ("stl", {}, False, {}),
}


def event_key(e):
    """What a traced run's event says, without its times and values."""
    return (e["kind"], e.get("name"), e.get("cat"), e.get("round"),
            e.get("direction"), e.get("peer"))


def make_strategy(name, cfg, C, **kw):
    kind, opts, _, _ = SCENARIOS[name]
    if kind == "fedstil":
        opts = dict(opts, n_clients=C)
    return STRATEGIES[kind](cfg, epochs=1, **opts, **kw)


def summary(res, strategy, tracer=None):
    """What a run's result says, as plain values."""
    out = {"rounds": res.rounds, "breakdown": res.comm_breakdown(),
           "c2s": res.comm.total_c2s, "s2c": res.comm.total_s2c,
           "measured": res.comm.measured, "storage": res.storage_bytes,
           "last_W": getattr(strategy, "last_W", None)}
    if tracer is not None:
        out["events"] = [event_key(e) for e in tracer.events]
        out["metrics"] = [e["values"] for e in tracer.events
                          if e["kind"] == "metric"]
    return out


def engine_runs(init, names):
    """Every named scenario on the sharded engine over the whole world,
    from the carried initial weights ``init``."""
    from repro_torch.core.edge_model import EdgeModelConfig
    bench = FederatedReIDBenchmark(**BENCH_KW)
    cfg = EdgeModelConfig(n_classes=bench.n_classes)
    out = {}
    for name in names:
        strategy = make_strategy(name, cfg, bench.n_clients)
        _, _, traced, run_kw = SCENARIOS[name]
        tracer = obs.Tracer() if traced else None
        res = run_simulation(strategy, bench, engine="sharded", device="cpu",
                             init_params=init, trace=tracer, **RUN_KW,
                             **run_kw)
        out[name] = summary(res, strategy, tracer)
    return out


def collectives(agg_inputs, eval_inputs, fr_inputs, hier_inputs):
    """On a world of 4 or 8 ranks: the sharded aggregate over "data" x
    "model", the sharded evaluation, ``fed_round`` on a (world / 2, 2)
    mesh, and (world 4) ``fed_round_hierarchical`` on (pod 2, data 2).
    Returns each rank's blocks with their coordinates."""
    import torch.distributed as dist
    n = dist.get_world_size()
    out = {}
    mesh = make_debug_mesh(tp=2, dp=n // 2)
    w, thetas = (torch.from_numpy(a) for a in agg_inputs)
    B, Wn = sharded_fused_aggregate(w, S.place(thetas, ("data", "model"),
                                               mesh), mesh)
    out["aggregate"] = {"B": B.numpy(), "Wn": Wn.numpy(),
                        "rows": mesh.block(thetas.shape[0]),
                        "cols": mesh.block(thetas.shape[1], "model")}
    th, feats, hists = fr_inputs
    me = mesh.coords["data"]
    B, w_row = FR.fed_round(
        {"w": S.place(torch.from_numpy(th), ("data", "model"), mesh)[0]},
        torch.from_numpy(feats[me]), torch.from_numpy(hists[me]), mesh=mesh)
    out["fed_round"] = {"me": me, "cols": mesh.block(th.shape[1], "model"),
                        "B": B["w"].numpy(), "w_row": w_row.numpy()}
    out["eval"] = ER.evaluate(make_debug_mesh(tp=1, dp=n), eval_inputs)
    if n == 4:
        pods = make_debug_mesh(tp=1, dp=2, multi_pod=True)
        th, feats, hists = hier_inputs          # (pods, C, ...) each
        p, i = pods.coords["pod"], pods.coords["data"]
        B, w_row = FR.fed_round_hierarchical(
            {"w": torch.from_numpy(th[p, i])}, torch.from_numpy(feats[p, i]),
            torch.from_numpy(hists[p, i]), mesh=pods)
        out["hierarchical"] = {"pod": p, "me": i, "B": B["w"].numpy(),
                               "w_row": w_row.numpy()}
    return out


def world(init, names, collective_inputs=None):
    """One spawned world's whole share: the engine scenarios, then (given
    their inputs) the collectives."""
    out = {"runs": engine_runs(init, names)}
    if collective_inputs is not None:
        out["coll"] = collectives(*collective_inputs)
    return out


def main(argv):
    """The named scenarios (``argv[1:]``) from the port's seeded weights on
    the sharded engine over ``torchrun``'s world, which ``run_simulation``
    joins; rank 0 writes each one's rounds and bytes to ``argv[0]``."""
    out = engine_runs(None, argv[1:])
    if int(os.environ["RANK"]) == 0:
        keep = ("rounds", "breakdown", "c2s", "s2c", "storage")
        with open(argv[0], "w") as f:
            json.dump({n: {k: r[k] for k in keep} for n, r in out.items()},
                      f)


if __name__ == "__main__":
    main(sys.argv[1:])
