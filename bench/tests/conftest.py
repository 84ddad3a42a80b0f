"""Shared set-up of the benchmark's CPU tests: the repository's root and
``src`` on the path, and small copies of the cells' config and traffic
files (the published architectures at a size the CPU runs in seconds)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

SMALL_ARCH = {"num_hidden_layers": 3, "hidden_size": 128,
              "num_attention_heads": 4, "intermediate_size": 256,
              "vocab_size": 2000}
SMALL_TRAFFIC = {"train": {"batch": 2, "seq": 128, "pool": 4},
                 "decode": {"batch": 2, "slots": 192, "prompt": 64}}


def small_cell(name: str, **arch):
    """(manifest, config, traffic) of cell ``name`` cut to a CPU size:
    the config's widths shrunk (GQA and head_dim kept as the file has
    them), the traffic's batch and lengths shortened."""
    man = harness.manifest()
    cell = harness.workload(man, name)
    conf = harness.load_json(
        ROOT / harness.config_entry(man, cell["config"])["file"])
    group = conf["num_attention_heads"] // conf["num_key_value_heads"]
    conf.update(SMALL_ARCH)
    conf["num_key_value_heads"] = SMALL_ARCH["num_attention_heads"] // group
    if "head_dim" in conf:
        conf["head_dim"] = 32
    conf.update(arch)
    traffic = harness.load_json(harness.BENCH / "traffic" /
                                f"{cell['traffic']}.json")
    traffic.update(SMALL_TRAFFIC[traffic["kind"]])
    return man, conf, traffic


@pytest.fixture
def steps(monkeypatch):
    """Make the harness's window a fixed number of steps, so that what a
    CPU test compares does not depend on how busy the host is."""
    import time

    def fix(n: int):
        def window(drv, seconds):
            stamps, attempted, failed = [], 0, 0
            t0 = time.perf_counter()
            for _ in range(n):
                a, f = drv.step()
                attempted, failed = attempted + a, failed + f
                stamps.append(time.perf_counter())
            return t0, stamps, attempted, failed
        monkeypatch.setattr(harness, "window", window)
    return fix
