"""The harness is general: a cell whose config has none of a dense LM's
keys runs through it on a driver kind of its own, found by the name in
its traffic file, and the harness reads nothing of the config itself."""
from __future__ import annotations

import sys
import types

import pytest
import torch

from bench import harness

CONF = {"name": "stub", "source": "https://example.org/stub",
        "rows": 64, "deployment": {"chips": 1}}
TRAFFIC = {"kind": "stub_kind", "per_step": 3}


class StubDriver:
    """Counts rows: each step adds ``per_step`` to a tally on the device,
    and the check compares the tally with the count of steps."""

    def __init__(self, run):
        self.run, self.steps = run, 0
        self.n = run.traffic["per_step"]
        self.tally = torch.zeros((), device=run.device)

    def step(self):
        with self.run.spans("bench.stub_step"):
            self.tally += self.n
            self.steps += 1
        return 1, 0

    def counters(self):
        return {"calls": self.steps}

    def end_to_end(self, t0, stamps):
        return {"rows_per_s": self.n * len(stamps) / (stamps[-1] - t0)}

    def work(self):
        return {"rows": self.n * self.steps}

    def free(self):
        self.total = float(self.tally)
        del self.tally

    def check(self):
        return {"tally_gap": abs(self.total - self.n * self.steps)}, {}

    def controls(self):
        return {}


MAN = {"configs": [{"name": "stub", "file": "bench/configs/stub.json"}],
       "workloads": [{"name": "stub.rows", "config": "stub",
                      "traffic": "stub_rows", "chips": 1}],
       "end_to_end": [{"name": "setup_s", "unit": "s"},
                      {"name": "rows_per_s", "unit": "rows/s",
                       "workloads": ["stub.rows"]}],
       "per_layer": [{"name": "idle_share.train", "unit": "%",
                      "workloads": ["stub.rows"]}]}


@pytest.fixture
def stub_kind(monkeypatch, steps):
    mod = types.ModuleType("bench.drivers.stub_kind")
    mod.Driver = StubDriver
    monkeypatch.setitem(sys.modules, "bench.drivers.stub_kind", mod)
    steps(5)


def test_harness_runs_a_cell_of_another_family(stub_kind):
    assert not {"num_key_value_heads", "rms_norm_eps", "rope_theta",
                "architecture", "hidden_size"} & set(CONF)
    result, extra = harness.run_cell(
        MAN, "stub.rows", 2 ** 31 + 3, 1.0, False, torch.device("cpu"),
        conf=dict(CONF), traffic=dict(TRAFFIC),
        limits={"tally_gap": 0.0}, setup_clock=lambda: 1.5)
    assert result["correct"] and result["attempted"] == 5
    assert set(result["metrics"]) == {"setup_s", "rows_per_s"}
    assert result["metrics"]["setup_s"]["value"] == 1.5
    assert result["checks"] == {"tally_gap": {"value": 0.0, "limit": 0.0}}
    assert extra["steps"] == 5


def test_harness_lists_only_the_per_layer_metrics_naming_the_cell():
    assert [m["name"] for m in harness.per_layer_metrics(MAN, "stub.rows")
            ] == ["idle_share.train"]
    assert harness.per_layer_metrics(MAN, "other.cell") == []
