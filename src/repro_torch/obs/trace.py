"""Span tracer with explicit device-sync boundaries.

The port of ``repro/obs/trace.py``, with the same event schema and JSONL.
The engines are instrumented with the module-level helpers::

    from repro_torch.obs import trace as obs

    with obs.span("server.relevance", cat="stage", round=rnd) as sp:
        out = relevance(...)
        sp.sync(out)          # wait for the card: honest span end

    obs.metric("server.relevance", {"staleness": stale}, round=rnd)

and a run activates a tracer around its loop::

    tracer = obs.Tracer("run.jsonl")
    with obs.active(tracer):
        run_simulation(...)
    tracer.close()            # flush JSONL (active() does NOT close)

When no tracer is active the helpers dispatch to the null tracer: the
span context manager is a shared constant object, ``sp.sync(x)`` returns
``x`` WITHOUT waiting (launches stay asynchronous: tracing off adds no
device-sync point), and ``metric()`` returns before touching its value
dict. Callers that must compute a metric's values first guard that with
``is_active()``.

Timing semantics with a tracer active: a span records host wall time
(``perf_counter``) from ``__enter__`` to ``__exit__``; calling
``sp.sync(tensors)`` inside the body waits until the device work behind
them is done, so the recorded duration covers execution, not just the
launches. Event schema (one JSON object per line):

    {"kind": "span",   "name": ..., "t0": s, "dur": s, ...attrs}
    {"kind": "metric", "name": ..., "values": {...}, "t0": s, ...attrs}
    {"kind": "meta",   ...}
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch


class RunLog:
    """Append-only JSONL sink for telemetry events.

    Events are buffered in memory and written on ``flush()``/``close()``
    — never inside the hot loop, so an active tracer costs list appends,
    not I/O. ``RunLog.read(path)`` parses a file back to event dicts.
    """

    def __init__(self, path):
        self.path = Path(path)
        self._buf: List[Dict[str, Any]] = []

    def append(self, event: Dict[str, Any]) -> None:
        self._buf.append(event)

    def flush(self) -> None:
        if not self._buf:
            return
        with self.path.open("a") as f:
            for e in self._buf:
                f.write(json.dumps(e) + "\n")
        self._buf.clear()

    def close(self) -> None:
        self.flush()

    @staticmethod
    def read(path) -> List[Dict[str, Any]]:
        events = []
        with Path(path).open() as f:
            for line in f:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
        return events


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in a tensor / dict / list / tuple
    tree (other leaves are skipped)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class _Span:
    """One live span (the same surface as ``_NULL_SPAN``)."""

    __slots__ = ("tracer", "name", "attrs", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0

    def sync(self, value):
        """Wait until the device work behind every tensor in ``value`` (a
        tensor, or a dict / list tree of them) is done; returns ``value``.
        The honest end-of-span device boundary; nothing to wait for on the
        CPU."""
        for dev in _cuda_devices(value, set()):
            torch.cuda.synchronize(dev)
        return value

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.tracer._emit({"kind": "span", "name": self.name,
                           "t0": self.t0, "dur": t1 - self.t0, **self.attrs})
        return False


class _NullSpan:
    """The tracing-off span: no timestamps, no waiting, one shared
    instance. ``sync`` is the identity — launches stay asynchronous."""

    __slots__ = ()

    def sync(self, value):
        return value

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Dispatch target when tracing is off. Every hook is a near-no-op."""

    active = False

    def span(self, name, **attrs):
        return _NULL_SPAN

    def metric(self, name, values=None, **attrs):
        return None

    def meta(self, **fields):
        return None

    def close(self):
        return None


class Tracer(NullTracer):
    """In-memory span/metric recorder with an optional JSONL sink.

    ``path=None`` keeps everything in ``self.events`` (callers read it
    directly); with a path, ``close()`` flushes the run to JSONL. The
    epoch (first event's perf_counter) is recorded as a meta event so
    reports can print relative times.
    """

    active = True

    def __init__(self, path=None):
        self.events: List[Dict[str, Any]] = []
        self.runlog = RunLog(path) if path is not None else None
        self.meta(epoch=time.perf_counter())

    def _emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)
        if self.runlog is not None:
            self.runlog.append(event)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def metric(self, name: str, values: Optional[Dict[str, Any]] = None,
               **attrs) -> None:
        self._emit({"kind": "metric", "name": name,
                    "values": _jsonable(values or {}),
                    "t0": time.perf_counter(), **attrs})

    def meta(self, **fields) -> None:
        self._emit({"kind": "meta", **_jsonable(fields)})

    def close(self) -> None:
        if self.runlog is not None:
            self.runlog.close()


def _jsonable(values: Dict[str, Any]) -> Dict[str, Any]:
    """Tensor / numpy values -> JSON-serializable (the ONE host readback
    point for device metrics — only reached with tracing on)."""
    out = {}
    for k, v in values.items():
        if isinstance(v, (str, bool, type(None))):
            out[k] = v
        elif np.isscalar(v):
            out[k] = float(v)
        elif isinstance(v, dict):
            out[k] = _jsonable(v)
        else:
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            arr = np.asarray(v)
            out[k] = float(arr) if arr.ndim == 0 else arr.tolist()
    return out


# ---------------------------------------------------------------------------
# global active tracer
# ---------------------------------------------------------------------------

_NULL = NullTracer()
_ACTIVE: NullTracer = _NULL


def activate(tracer: Tracer) -> Tracer:
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = _NULL


def get_tracer() -> NullTracer:
    return _ACTIVE


def is_active() -> bool:
    return _ACTIVE.active


@contextlib.contextmanager
def active(tracer: Tracer):
    """Activate ``tracer`` for the duration of the block (restores the
    previous tracer on exit; does NOT close — callers own the sink)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def suspended():
    """Temporarily disable tracing (an overhead measurement's baseline runs
    under this so an outer tracer never contaminates it)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = _NULL
    try:
        yield
    finally:
        _ACTIVE = prev


def span(name: str, **attrs):
    return _ACTIVE.span(name, **attrs)


def metric(name: str, values: Optional[Dict[str, Any]] = None, **attrs):
    return _ACTIVE.metric(name, values, **attrs)


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------


def chrome_trace(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Events -> the Chrome-trace ``traceEvents`` JSON (open in
    chrome://tracing or ui.perfetto.dev). Spans become complete ("X")
    events; metrics become instant ("i") events with their values in
    ``args``. Timestamps are rebased to the run's first event."""
    events = list(events)
    t0s = [e.get("t0") for e in events if e.get("t0") is not None]
    epoch = min(t0s) if t0s else 0.0
    trace_events = []
    for e in events:
        if e.get("kind") == "span":
            args = {k: v for k, v in e.items()
                    if k not in ("kind", "name", "t0", "dur")}
            trace_events.append({
                "name": e["name"], "ph": "X", "pid": 0,
                "tid": e.get("cat", "main"),
                "ts": (e["t0"] - epoch) * 1e6, "dur": e["dur"] * 1e6,
                "args": args})
        elif e.get("kind") == "metric":
            trace_events.append({
                "name": e["name"], "ph": "i", "pid": 0, "tid": "metrics",
                "ts": (e.get("t0", epoch) - epoch) * 1e6, "s": "t",
                "args": e.get("values", {})})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
