"""The control of a cell's correctness check, on the card: for each seed,
one run of the cell (set-up, a window of ``--seconds``, the check) with
the readings of the control and of the faults beside the program's, all
against the same fp32 reference. The benchmark's own runs never run it.

  control (the reference computed in fp8 in the program's place): the
    train cells' loss, gradient and change gaps; the decode cells' widest
    gap of the token the fp8 reference puts first at each position of
    the served requests;
  half_batch (train cells: the reference's loss over half the rows, the
    mean taken over the rest).

A state left unchanged reads 1 in the train cells' gradient and change
gaps by their definition and needs no run.

Usage, from the repository's root, on a machine with the card:

  python3 bench/control.py --workload qwen3-1.7b.split_train_4k \\
      --seeds 11,12,13 --seconds 2 [--out control.jsonl]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    man = harness.manifest()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, extra = harness.run_cell(
            man, args.workload, seed, args.seconds, False,
            torch.device("cuda", 0), controls=True,
            setup_clock=lambda: 0.0)
        row = {"workload": args.workload, "seed": seed,
               "program": {k: c["value"] for k, c in
                           result["checks"].items()},
               "limits": {k: c["limit"] for k, c in
                          result["checks"].items()},
               "controls": extra["controls"], "details": extra["details"],
               "steps": extra["steps"],
               "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
