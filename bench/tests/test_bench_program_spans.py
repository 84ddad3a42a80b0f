"""The per-layer metrics that read the program's spans, on made-up
profiling sessions: each reads its parts' device (or host) ms a step;
each reads nothing where the session holds another number of steps than
the window, where a part carries no device time, where there is no
session, or where the program has no spans to read (an older tree)."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench import devtrace, harness
from conftest import small_cell
from repro_torch.obs import trace as PT

MAN = harness.manifest()
READERS = {  # metric -> (kind, parts, clock)
    "head_ms.train": ("train", ("lm.head", "train.head_bwd"), "dev"),
    "optimizer_ms.train": ("train", ("train.clip", "train.adam"), "dev"),
    "trunk_ms.train": ("train", ("lm.trunk",), "dev"),
    "enqueue_ms.train": ("train", ("train.step",), "host"),
    "kv_read_ms.decode": ("decode", ("decode.kv_read",), "dev"),
    "attend_ms.decode": ("decode", ("decode.attend",), "dev"),
    "enqueue_ms.decode": ("decode", ("decode.step",), "host"),
}
LEAVES = {"train": ["train.combine", "lm.trunk", "lm.adaptive", "lm.head",
                    "lm.head", "train.head_bwd", "train.adaptive_bwd",
                    "train.clip", "train.adam"],
          "decode": ["decode.qkv", "decode.kv_read", "decode.attend",
                     "decode.out"] * 3 + ["decode.head"]}


def _session(kind: str, n_steps: int, dev: bool = True) -> PT.Tracer:
    """A made-up session of ``n_steps`` steps: the i-th leaf of a step
    takes i + 1 ms on the host and 2 (i + 1) ms on the device, the step
    the leaves' sum plus 1 ms on each."""
    tr = PT.Tracer()
    for _ in range(n_steps):
        host = devs = 0.0
        for i, name in enumerate(LEAVES[kind]):
            e = {"kind": "span", "name": name, "cat": "phase",
                 "t0": host, "dur": (i + 1) * 1e-3, "t0_ns": 0, "t1_ns": 0}
            if dev:
                e["dev"] = 2 * (i + 1) * 1e-3
            tr._emit(e)
            host, devs = host + e["dur"], devs + 2 * (i + 1) * 1e-3
        step = {"kind": "span", "name": f"{kind}.step", "cat": "step",
                "t0": 0.0, "dur": host + 1e-3, "t0_ns": 0, "t1_ns": 0}
        if dev:
            step["dev"] = devs + 1e-3
        tr._emit(step)
    return tr


def _want_ms(kind: str, parts, clock: str) -> float:
    """What the made-up session gives a step for ``parts``."""
    leaves = LEAVES[kind]
    per = {}
    for i, name in enumerate(leaves):
        per[name] = per.get(name, 0.0) + (i + 1) * (2 if clock == "dev"
                                                     else 1)
    step_ms = sum((i + 1) * (2 if clock == "dev" else 1)
                  for i in range(len(leaves))) + 1
    per[f"{kind}.step"] = step_ms
    return sum(per[p] for p in parts)


@pytest.fixture
def session(monkeypatch):
    def use(tracer):
        monkeypatch.setattr(PT, "_PROFILED", tracer)
        monkeypatch.setattr(PT, "_OFF_SEEN", tracer is None)
    return use


def _ctx(kind: str, n_steps: int):
    return {"kind": kind, "n_steps": n_steps}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_its_parts_ms_a_step(session, metric):
    kind, parts, clock = READERS[metric]
    session(_session(kind, 4))
    got = harness.metric_reader(metric)(_ctx(kind, 4))
    assert got == pytest.approx(_want_ms(kind, parts, clock))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_from_a_partial_or_stale_session(session,
                                                              metric):
    kind = READERS[metric][0]
    session(_session(kind, 3))
    read = harness.metric_reader(metric)
    assert read(_ctx(kind, 4)) is None
    assert read(_ctx(kind, 2)) is None
    assert read(_ctx(kind, 0)) is None
    other = "decode" if kind == "train" else "train"
    session(_session(other, 4))
    assert read(_ctx(kind, 4)) is None
    session(None)
    assert read(_ctx(kind, 4)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_needs_device_time_for_device_ms(session, metric):
    kind, parts, clock = READERS[metric]
    session(_session(kind, 4, dev=False))
    got = harness.metric_reader(metric)(_ctx(kind, 4))
    if clock == "dev":
        assert got is None
    else:
        assert got == pytest.approx(_want_ms(kind, parts, clock))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_of_a_program_without_spans_reads_nothing(monkeypatch,
                                                         metric):
    monkeypatch.delattr(PT, "phase_totals")
    kind = READERS[metric][0]
    assert harness.metric_reader(metric)(_ctx(kind, 4)) is None


def test_every_span_metric_is_declared_and_lists_its_kinds_cells():
    declared = {m["name"]: m for m in MAN["per_layer"]}
    traffic = {w["name"]: w["traffic"] for w in MAN["workloads"]}
    kinds = {t: harness.load_json(harness.BENCH / "traffic" /
                                  f"{t}.json")["kind"]
             for t in set(traffic.values())}
    for name, (kind, _, _) in READERS.items():
        m = declared[name]
        assert (m["source"], m["unit"], m["better"]) == (
            "program_span", "ms", "lower")
        assert sorted(m["workloads"]) == sorted(
            c for c, t in traffic.items() if kinds[t] == kind)


@pytest.mark.parametrize("cell", ["qwen3-1.7b.split_train_4k",
                                  "qwen1.5-0.5b.decode_32k"])
def test_a_profiled_window_of_a_cell_reads_host_ms(cell):
    """The cell at a CPU size, its window's steps under the CPU
    profiler: the session holds the window's steps, the host readers read
    them, the device readers nothing (no device time on the CPU), and the
    program's rows lay against the profiler's events through
    ``devtrace.reduce`` without a device event."""
    man, conf, traffic = small_cell(cell)
    run = harness.Run(name=cell, conf=conf, traffic=traffic,
                      seed=2 ** 31 + 11, device=torch.device("cpu"),
                      spans=devtrace.Spans(False))
    drv = harness.driver_class(traffic["kind"])(run)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            drv.step()
    kind = traffic["kind"]
    for metric, (k, _, clock) in READERS.items():
        if k != kind:
            continue
        got = harness.metric_reader(metric)(_ctx(kind, 3))
        assert (got is None) == (clock == "dev"), metric
        if got is not None:
            assert got > 0
    rows = PT.profiled().rows()
    assert sum(r[2] == f"{kind}.step" for r in rows) == 3
    red = devtrace.reduce(devtrace.raw_events(prof), rows)
    assert red["device_events"] == 0
    drv.free()
