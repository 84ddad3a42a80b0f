"""Run one cell of the benchmark once and print its result.

Usage, from the repository's root:

  python3 bench/run.py --workload qwen3-1.7b.split_train_4k --seed 7 \\
      --seconds 51 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a window under ``torch.profiler``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
``checks``: each number the correctness check compared, beside its
limit); the last lines of standard error repeat the checks. A host
without a CUDA card, or with fewer cards than the cell asks for, exits
with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    import repro_torch  # noqa: F401  (the system under test: none, no run)
    from bench import harness

    man = harness.manifest()
    cell = harness.workload(man, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload}: needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, extra = harness.run_cell(man, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(extra), file=sys.stderr)
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
