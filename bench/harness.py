"""One run of one cell: set-up, the measured window, the check, the result.

Everything about a cell is found by name from ``BENCHMARK.json``: the
workload names a config (``bench/configs/<config>.json``) and a traffic
mix (``bench/traffic/<traffic>.json``), whose ``kind`` names the driver
(``bench/drivers/<kind>.py``); the cell's limits are in
``bench/cells/<workload>.json``; each per-layer metric is read by
``bench/metrics/<metric>.py``. Adding a cell, a config, a mix or a metric
adds files and entries; no file here changes.

The window is a closed loop of the driver's steps, each ending in a host
readback, for ``--seconds``: it closes at the end of the first step that
ends past that length, and a rate is taken over every step and all the
time from the window's start to that step's end. Set-up (``setup_s``) is
the time from the process's start to the window's start.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from bench import devtrace
from bench.peaks import peaks

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def since_process_start() -> float:
    """Seconds since this process started (the kernel's start time of the
    process against the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf(
        "SC_CLK_TCK")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(man: Dict, name: str) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Run:
    """What a driver is handed: the cell's files, the seed, the device.
    The driver reads its model from ``conf`` itself."""
    name: str
    conf: Dict
    traffic: Dict
    seed: int
    device: torch.device
    spans: devtrace.Spans


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def driver_class(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}").Driver


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_metrics(man: Dict, cell: str):
    """The per-layer metrics a cell reports: those that list it."""
    return [m for m in man["per_layer"] if cell in m["workloads"]]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(drv, seconds: float):
    """The closed loop -> (start, each step's end, attempted, failed)."""
    stamps, attempted, failed = [], 0, 0
    t0 = time.perf_counter()
    while True:
        a, f = drv.step()
        attempted, failed = attempted + a, failed + f
        t = time.perf_counter()
        stamps.append(t)
        if t - t0 >= seconds:
            return t0, stamps, attempted, failed


def run_cell(man: Dict, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, *, limits: Optional[Dict] = None,
             setup_clock=since_process_start, controls: bool = False,
             conf: Optional[Dict] = None, traffic: Optional[Dict] = None):
    """Run one cell once -> the result dict (``checks`` last), and with
    ``controls`` the control's and the faults' readings beside it.
    ``conf``, ``traffic`` and ``limits`` default to the cell's files."""
    cell = workload(man, name)
    conf = conf or load_json(ROOT / config_entry(man, cell["config"])["file"])
    traffic = traffic or load_json(BENCH / "traffic" /
                                   f"{cell['traffic']}.json")
    limits = limits or load_json(BENCH / "cells" / f"{name}.json")["limits"]
    run = Run(name=name, conf=conf, traffic=traffic, seed=seed,
              device=device, spans=devtrace.Spans(False))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)   # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)

    drv = driver_class(traffic["kind"])(run)
    before = drv.counters()
    _sync(device)
    setup_s = setup_clock()
    if trace:
        run.spans.on = True
        with devtrace.profiler(device) as prof:
            t0, stamps, attempted, failed = window(drv, seconds)
            _sync(device)
            t_read = time.perf_counter()
        run.spans.on = False
        events = devtrace.raw_events(prof)
    else:
        t0, stamps, attempted, failed = window(drv, seconds)
        _sync(device)
    window_s = stamps[-1] - t0
    after = drv.counters()
    peak_bytes = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    metrics: Dict[str, Dict] = {}
    if trace:
        red = devtrace.reduce(events, run.spans.rows)
        del events, prof
        trace_read_s = time.perf_counter() - t_read
        ctx = {"kind": traffic["kind"], "window_s": window_s,
               "steps_s": [b - a for a, b in zip([t0] + stamps, stamps)],
               "n_steps": len(stamps), "trace": red,
               "counters": {k: after[k] - before[k] for k in after},
               "work": drv.work(), "peaks": peaks(dev_info["kind"])}
        for m in per_layer_metrics(man, name):
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=red["busy_s"], window_s=window_s)
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
    else:
        e2e = dict(drv.end_to_end(t0, stamps), setup_s=setup_s)
        for m in man["end_to_end"]:
            if name in m.get("workloads", [name]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev_info
    if trace:
        result["breakdown"] = breakdown

    drv.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, details = drv.check()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
              if k in limits}
    details["not_compared"] = {k: v for k, v in numbers.items()
                               if k not in limits}
    result["correct"] = bool(failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    result["checks"] = checks
    extra = {"setup_s": setup_s, "window_s": window_s, "steps": len(stamps),
             "details": details}
    if trace:
        extra.update(trace_read_s=trace_read_s,
                     device_events=red["device_events"],
                     groups_ms_per_step={g: 1e3 * v / len(stamps) for g, v in
                                         red["groups_s"].items()})
    if controls:
        extra["controls"] = drv.controls()
    return result, extra


def check_lines(result: Dict):
    return [f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for k, c in result["checks"].items()]
