#!/usr/bin/env python3
"""The paper's protocol on the stacked and the sharded engine, interleaved
on one card, to tell the sharded engine's host cost from the host's drift.

    python3 scripts/sharded_ab.py [PAIRS] [ROUNDS]     # from the repo root

Builds the kernels, then runs FedSTIL (C = 5, T = 6, 5 epochs, float32
wire, device evaluation; ``chip_smoke.py``'s round_fedstil) for ROUNDS
rounds (60 by default) under a tracer, PAIRS times (4 by default) in the
order stacked, sharded, sharded, stacked, ..., and a third arm: the
stacked engine run inside an NCCL world of one (``engine_world``), which
keeps the process group's background threads alive without any of the
sharded engine's own work. Each run prints one ``AB`` JSON line: the arm,
the median round wall and stage ms (the traced spans), the run's wall.
The last line is the per-arm medians of those medians. Needs a CUDA card.
"""
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.edge_model import EdgeModelConfig  # noqa: E402
from repro_torch.core.fedstil import FedSTIL  # noqa: E402
from repro_torch.data import FederatedReIDBenchmark  # noqa: E402
from repro_torch.federated import run_simulation  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402
from repro_torch.sharding import specs as SH  # noqa: E402

SEED, CLIENTS = 0, 5
STAGES = ("wall_ms", "gather", "local_train", "server", "apply", "eval")


def run(arm, bench, dev, rounds):
    strategy = FedSTIL(EdgeModelConfig(n_classes=bench.n_classes),
                       n_clients=CLIENTS, wire_dtype="float32")
    kw = dict(rounds=rounds, seed=SEED, device=dev, trace=obs.Tracer(),
              engine="sharded" if arm == "sharded" else "stacked")
    t0 = time.perf_counter()
    if arm == "stacked_in_world":
        with SH.engine_world(dev):
            res = run_simulation(strategy, bench, **kw)
    else:
        res = run_simulation(strategy, bench, **kw)
    wall = time.perf_counter() - t0
    return {"arm": arm, "run_s": wall, **{
        k: statistics.median(s.get(k, 0.0) for s in res.stage_ms)
        for k in STAGES}}


def main():
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 60
    dev = torch.device("cuda", 0)
    _build.build_all()
    bench = FederatedReIDBenchmark(seed=SEED)
    run("stacked", bench, dev, 2)                  # warm-up: first launches
    order = []
    for i in range(pairs):
        a, b = ("stacked", "sharded") if i % 2 == 0 else ("sharded",
                                                            "stacked")
        order += [a, b, "stacked_in_world"]
    rows = []
    for arm in order:
        row = run(arm, bench, dev, rounds)
        rows.append(row)
        print("AB " + json.dumps(row), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rounds": rounds,
                      "medians": {arm: {k: statistics.median(
                          r[k] for r in rows if r["arm"] == arm)
                          for k in STAGES + ("run_s",)}
                          for arm in dict.fromkeys(order)}}), flush=True)


if __name__ == "__main__":
    main()
