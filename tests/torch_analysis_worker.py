"""The full lint of ``tests/test_torch_analysis.py`` in a process of its
own: the sharded programs trace in a fake world of one
(``repro_torch.analysis.manifest.one_rank_mesh``) and a process holds one
default group, so the lint runs where no test has a world up.

    python tests/torch_analysis_worker.py OUT.json

runs the full lint, then each sharded program's lint again in this one
process (each makes and destroys its world: the second trace must work
too), and writes the summaries as JSON. Imports no JAX.
"""
import json
import sys

import torch.distributed as dist

from repro_torch.analysis import lint


def summary(report):
    new, base, stale = lint.partition_findings(
        report["findings"], lint.load_baseline(lint.BASELINE_PATH))
    return {"programs": report["programs"],
            "findings": [f.as_dict() for f in new],
            "baselined": [f.as_dict() for f in base],
            "stale_suppressions": stale,
            "world_left_up": dist.is_initialized()}


SHARDED = ("federated.sharded_aggregate", "federated.sharded_eval",
           "federated.sharded_server_round")


def main(out):
    runs = [summary(lint.run())]
    runs += [summary(lint.run(name)) for name in SHARDED]
    with open(out, "w") as f:
        json.dump(runs, f)


if __name__ == "__main__":
    main(sys.argv[1])
