"""The traced run: the benchmark's own host spans around its calls into
the program, and ``torch.profiler`` over the measured window recording
the card's side alone (kernels, copies, fills; not the host's operators,
which would cost more to record and read than the window lasts), read
back from its raw events into device busy time, device time by kernel
group and by kernel, and the device's idle gaps named by the span the
host was in.

The spans are stamped with the host's real-time clock, the clock the
profiler's events are given in. No trace file is written: the events are
read in memory once the window has closed.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

# kernel-name substrings -> group, first match wins (cuBLAS's Hopper
# matmuls are named nvjet_*); the grouping the port's card script uses
KERNEL_GROUPS = (("flash_fwd_tensor_cores", ("fwd_kernel_sm90",)),
                 ("flash_bwd_tensor_cores", ("dq_kernel_sm90",
                                             "dkv_kernel_sm90")),
                 ("flash", ("fwd_kernel", "dq_kernel", "dkv_kernel")),
                 ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
                 ("combine", ("combine",)),
                 ("copy", ("copy",)),
                 ("elementwise", ("elementwise", "vectorized")),
                 ("reduce", ("reduce",)))


def group_of(name: str) -> str:
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), "other")


class Spans:
    """The benchmark's host spans, (start ns, end ns, name), recorded only
    when the run is traced."""

    def __init__(self, on: bool):
        self.on = on
        self.rows: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.rows.append((t0, time.time_ns(), name))


def profiler(device: torch.device):
    """The profiler the traced window runs under: the card's activity."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                   with_stack=False, profile_memory=False)


def raw_events(prof) -> list:
    if prof is None:
        return []
    return list(prof.profiler.kineto_results.events())


def _end(e) -> int:
    return e.start_ns() + e.duration_ns()


def _on_device(e) -> bool:
    """A kernel, copy or fill that ran on the card (not the projection of
    a host span onto the card's timeline)."""
    return e.device_type() == torch.autograd.DeviceType.CUDA and \
        not e.is_user_annotation()


def device_events(events) -> List[Tuple[int, int, str]]:
    """The card's operations, (start ns, end ns, name) sorted by start."""
    return sorted((e.start_ns(), _end(e), e.name()) for e in events
                  if _on_device(e))


def _merged(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e, _ in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events, spans: List[Tuple[int, int, str]], top: int = 10) -> Dict:
    """Busy seconds, seconds by kernel group and by kernel, the top
    kernels, and idle seconds by the benchmark span the host was in,
    within the span of the benchmark's spans (the measured window)."""
    dev = device_events(events)
    spans = sorted(spans)
    if not dev or not spans:
        return {"busy_s": 0.0, "groups_s": {}, "kernels_s": {},
                "device_ops": [], "idle_gaps": [], "device_events": len(dev)}
    lo, hi = spans[0][0], max(e for _, e, _ in spans)
    busy = _merged(dev, lo, hi)
    groups: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    for s, e, name in dev:
        sec = (min(e, hi) - max(s, lo)) / 1e9
        if sec <= 0:
            continue
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + sec
        kernels[name] = kernels.get(name, 0.0) + sec
    starts = [s for s, _, _ in spans]
    idle: Dict[str, float] = {}
    prev = lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            mid = (prev + s) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = spans[i][2] if i >= 0 and spans[i][1] >= mid \
                else "between spans"
            idle[name] = idle.get(name, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    by = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "groups_s": groups, "kernels_s": kernels,
            "device_ops": [[n[:160], s] for n, s in by(kernels)],
            "idle_gaps": [[n, s] for n, s in by(idle)],
            "device_events": len(dev)}
