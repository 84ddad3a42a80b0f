#!/usr/bin/env python3
"""The untraced round path of one checkout, timed, for an A/B between two
checkouts on one card.

    python3 scripts/telemetry_ab.py TREE LABEL [ROUNDS]   # from the repo root

Imports ``repro_torch`` from TREE's ``src/`` (``.`` for this checkout),
builds its kernels, and prints one ``AB`` JSON line:

  round      the paper's protocol (``chip_smoke.py``'s round_fedstil:
             FedSTIL, C = 5, T = 6, 5 epochs, stacked engine, device
             evaluation) run untraced for ROUNDS rounds (60 by default),
             three times, beside three runs of 0 rounds (the set-up: weights,
             prototypes, evaluation cache); the round wall is (run - set-up)
             / ROUNDS on the host clock, each run between two device syncs;
             the ``torch.cuda.synchronize`` calls a round makes
  codec      ``BatchedCodec.roundtrip`` of a residual at C = 1000, P = 57664
             under ``delta+topk`` and ``topk+int8`` (``wire_round_scale``'s
             operands): device ms (CUDA events behind a device-side
             sleep, median of 30 after a warm-up) and the peak device
             memory above what is held before it

A checkout whose ``run_simulation`` has no ``trace`` argument (before the
telemetry slice) syncs every stage of every round; one with it syncs
nothing untraced. Run parent, change, change, parent in one call on one
card (the parent unpacked with ``git archive`` into a gitignored
directory). Needs a CUDA card.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
CODEC_CLIENTS, CODEC_P = 1000, 57664
SLEEP_CYCLES = 5_000_000            # chip_smoke.py's, ahead of a timed call


def main():
    tree, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 60
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.comm.batched import BatchedCodec
    from repro_torch.comm.codec import make_codec
    from repro_torch.core import edge_model as EM
    from repro_torch.core.fedstil import FedSTIL
    from repro_torch.data import FederatedReIDBenchmark
    from repro_torch.federated import run_simulation
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("telemetry_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    _build.build_all()
    bench = FederatedReIDBenchmark(seed=SEED)
    cfg = EM.EdgeModelConfig(n_classes=bench.n_classes)
    synchronize = torch.cuda.synchronize
    n_sync = [0]

    def counted(*args, **kw):
        n_sync[0] += 1
        return synchronize(*args, **kw)

    def run(n):
        synchronize(dev)
        n_sync[0] = 0
        torch.cuda.synchronize = counted
        t0 = time.perf_counter()
        try:
            run_simulation(FedSTIL(cfg, n_clients=5), bench, rounds=n,
                           seed=SEED, engine="stacked", device=dev)
        finally:
            torch.cuda.synchronize = synchronize
        synchronize(dev)
        return (time.perf_counter() - t0) * 1e3, n_sync[0]

    run(2)                                            # warm-up
    setup, walls, syncs = [], [], []
    for _ in range(3):
        setup.append(run(0)[0])
        ms, n = run(rounds)
        walls.append(ms)
        syncs.append(n)
    base = min(setup)
    out = {"label": label, "rounds": rounds, "setup_ms": setup,
           "run_ms": walls,
           "round_wall_ms": [(w - base) / rounds for w in walls],
           "syncs_per_round": [n / rounds for n in syncs]}

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for codec in ("delta+topk", "topk+int8"):
        prog = BatchedCodec(make_codec(codec), CODEC_P)
        base_mat = torch.randn((CODEC_CLIENTS, CODEC_P), generator=gen,
                               device=dev)
        prog.roundtrip(base_mat)                      # the keyframe
        mat = base_mat + 0.01 * torch.randn(base_mat.shape, generator=gen,
                                            device=dev)
        times = []
        for i in range(35):
            torch.cuda._sleep(SLEEP_CYCLES)     # keep the enqueue out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prog.roundtrip(mat)
            end.record()
            end.synchronize()
            if i >= 5:
                times.append(start.elapsed_time(end))
        out[f"roundtrip_ms_{codec}"] = sorted(times)[len(times) // 2]
        synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prog.roundtrip(mat)
        synchronize()
        out[f"peak_bytes_{codec}"] = torch.cuda.max_memory_allocated() - held
        del prog, base_mat, mat
        torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
