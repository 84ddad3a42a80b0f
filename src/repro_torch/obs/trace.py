"""Span tracer: host and device time of each span, on the profiler's clock.

The port of ``repro/obs/trace.py``, with the same event schema and JSONL.
The engines are instrumented with the module-level helpers::

    from repro_torch.obs import trace as obs

    with obs.span("server.relevance", cat="stage", round=rnd) as sp:
        out = relevance(...)

    obs.metric("server.relevance", {"staleness": stale}, round=rnd)

and a run activates a tracer around its loop::

    tracer = obs.Tracer("run.jsonl")
    with obs.active(tracer):
        run_simulation(...)
    tracer.close()            # flush JSONL (active() does NOT close)

Spans also record, with no tracer active, while ``torch.profiler``
records: into a tracer the module keeps for that profiling session
(``profiled()``, read by ``phase_totals()``), which starts empty when a
session begins after a span was seen with the profiler off; such a span
ends the session for ``profiled()``, so a reader never takes a stale
one. While the
profiler records, each span also opens a ``record_function`` range of
its name, so a trace with CPU activity shows the phases beside the
kernels.

When neither records, the helpers dispatch to the null tracer: the span
context manager is a shared constant object, ``sp.sync(x)`` returns
``x`` WITHOUT waiting (launches stay asynchronous: tracing off adds no
device-sync point), and ``metric()`` returns before touching its value
dict. Callers that must compute a metric's values first guard that with
``is_active()``; metrics never follow the profiler.

Timing with a span recording: each boundary is stamped on the host's
clocks (``perf_counter`` for ``t0`` / ``dur``; ``time.time_ns()``, the
clock the profiler's events carry, for ``t0_ns`` / ``t1_ns``) and, once
CUDA is initialized in the process, by a CUDA event recorded on the
current stream. A span's device seconds (``dev``: from its first stamp's
event to its last's, idle gaps included) are read once both events are
complete (``event.query()``; the stamps are taken on the current stream,
where events complete in the order they were recorded): when the next
root span (one opened with no span open, a step) is entered, after the
caller's own readback; what is left when ``close()`` is called or
``events`` is read waits there. The events come from a pool and go back
to it once read. A span never waits on the device itself:
``sp.sync(tensors)`` does, for a caller that needs host time to cover
execution. On the CPU and on meta tensors a span carries host times
only.

``tile=True``: the span starts at the stamp where its previous sibling
ended, or where its parent began if it is the first child, so the work
between them counts to it and a step's tiling spans partition it with no
gap, on both clocks.

Event schema (one JSON object per line):

    {"kind": "span",   "name": ..., "t0": s, "dur": s, "t0_ns": ns,
     "t1_ns": ns, ["dev": s,] ...attrs}
    {"kind": "metric", "name": ..., "values": {...}, "t0": s, ...attrs}
    {"kind": "meta",   ...}
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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


class _Stamp:
    """One span boundary: both host clocks, and the CUDA event recorded
    there (``None`` on the CPU). ``refs``: the spans (and the tracer's
    cursor) holding it; at 0 its event goes back to the pool."""

    __slots__ = ("pc", "ns", "ev", "refs")

    def __init__(self, ev):
        self.ev = ev
        self.pc = time.perf_counter()
        self.ns = time.time_ns()
        self.refs = 1


class _Span:
    """One live span (the same surface as ``_NULL_SPAN``)."""

    __slots__ = ("tracer", "name", "attrs", "tile", "start", "rf")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 tile: bool = False):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.tile = tile
        self.start: Optional[_Stamp] = None
        self.rf = None

    def sync(self, value):
        """Wait until the device work behind every tensor in ``value`` (a
        tensor, or a dict / list tree of them) is done; returns ``value``.
        For a caller whose host time must cover execution; nothing to
        wait for on the CPU."""
        for dev in _cuda_devices(value, set()):
            torch.cuda.synchronize(dev)
        return value

    def __enter__(self):
        self.start = self.tracer._open_span(self)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        self.tracer._close_span(self)
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

    def span(self, name, tile=False, **attrs):
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

    Spans nest on one stack: a backward hook on autograd's device thread
    may close one span and open the next while the thread that entered
    the backward waits in it, never while another span changes.
    """

    active = True

    def __init__(self, path=None):
        self._events: List[Dict[str, Any]] = []
        self.runlog = RunLog(path) if path is not None else None
        self._open: List[_Span] = []
        self._cursor: Optional[_Stamp] = None   # where a tiling span starts
        self._pending: List[Tuple[Dict[str, Any], _Stamp, _Stamp]] = []
        self._free: list = []                   # CUDA events to reuse
        self.meta(epoch=time.perf_counter())

    @property
    def events(self) -> List[Dict[str, Any]]:
        """Every event so far, each span's device time read (waiting for
        the device where a span's events are not complete yet)."""
        self._resolve(wait=True)
        return self._events

    def _emit(self, event: Dict[str, Any]) -> None:
        self._events.append(event)
        if self.runlog is not None:
            self.runlog.append(event)

    # -- stamps ---------------------------------------------------------

    def _stamp(self) -> _Stamp:
        ev = None
        if torch.cuda.is_initialized():
            ev = (self._free.pop() if self._free
                  else torch.cuda.Event(enable_timing=True))
            ev.record()
        return _Stamp(ev)

    def _release(self, st: Optional[_Stamp]) -> None:
        if st is None:
            return
        st.refs -= 1
        if st.refs == 0 and st.ev is not None:
            self._free.append(st.ev)

    def _set_cursor(self, st: Optional[_Stamp]) -> None:
        if st is not None:
            st.refs += 1
        self._release(self._cursor)
        self._cursor = st

    def _open_span(self, sp: _Span) -> _Stamp:
        if not self._open:
            self._resolve(wait=False)
        if sp.tile and self._open and self._cursor is not None:
            start = self._cursor
            start.refs += 1
        else:
            start = self._stamp()
        self._open.append(sp)
        self._set_cursor(start)
        return start

    def _close_span(self, sp: _Span) -> None:
        end = self._stamp()
        self._open.remove(sp)
        self._set_cursor(end if self._open else None)
        start = sp.start
        event = {"kind": "span", "name": sp.name, "t0": start.pc,
                 "dur": end.pc - start.pc, "t0_ns": start.ns,
                 "t1_ns": end.ns, **sp.attrs}
        self._emit(event)
        if start.ev is not None and end.ev is not None:
            self._pending.append((event, start, end))
        else:
            self._release(start)
            self._release(end)

    def _resolve(self, wait: bool) -> None:
        """Read the device time of every pending span whose events are
        complete, in the order they closed; ``wait``: wait for them. The
        events are on one stream, where they complete in the order they
        were recorded: once the newest is complete, all are."""
        pending = self._pending
        if not pending:
            return
        done = len(pending)
        if wait:
            pending[-1][2].ev.synchronize()
        elif not pending[-1][2].ev.query():
            done = 0
            while done < len(pending) and pending[done][2].ev.query():
                done += 1
        for event, start, end in pending[:done]:
            event["dev"] = start.ev.elapsed_time(end.ev) / 1e3
            self._release(start)
            self._release(end)
        del pending[:done]

    # -- the hooks --------------------------------------------------------

    def span(self, name: str, tile: bool = False, **attrs) -> _Span:
        return _Span(self, name, attrs, tile)

    def metric(self, name: str, values: Optional[Dict[str, Any]] = None,
               **attrs) -> None:
        self._emit({"kind": "metric", "name": name,
                    "values": _jsonable(values or {}),
                    "t0": time.perf_counter(), **attrs})

    def meta(self, **fields) -> None:
        self._emit({"kind": "meta", **_jsonable(fields)})

    def close(self) -> None:
        self._resolve(wait=True)
        if self.runlog is not None:
            self.runlog.close()

    # -- reading ----------------------------------------------------------

    def rows(self) -> List[Tuple[int, int, str]]:
        """The spans as (start ns, end ns, name) on the profiler's clock,
        the rows ``torch.profiler``'s events can be laid against."""
        return [(e["t0_ns"], e["t1_ns"], e["name"]) for e in self._events
                if e["kind"] == "span"]

    def totals(self) -> Dict[str, Dict[str, Any]]:
        """Per span name: ``count``, host seconds ``host_s`` and device
        seconds ``dev_s`` summed over its spans (``None`` unless every one
        of them carries a device time)."""
        out: Dict[str, Dict[str, Any]] = {}
        for e in self.events:
            if e["kind"] != "span":
                continue
            t = out.setdefault(e["name"], {"count": 0, "host_s": 0.0,
                                           "dev_s": 0.0})
            t["count"] += 1
            t["host_s"] += e["dur"]
            if t["dev_s"] is not None:
                t["dev_s"] = (t["dev_s"] + e["dev"] if "dev" in e
                              else None)
        return out


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
# global active tracer, and the profiling session's
# ---------------------------------------------------------------------------

_NULL = NullTracer()
_ACTIVE: NullTracer = _NULL
_PROFILED: Optional[Tracer] = None
_OFF_SEEN = True       # a span met the profiler off since _PROFILED began


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


def recording() -> bool:
    """Whether a span records: a tracer is active, or ``torch.profiler``
    records."""
    return _ACTIVE.active or _autograd_profiler._is_profiler_enabled


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


def _profiled_session() -> Tracer:
    global _PROFILED, _OFF_SEEN
    if _OFF_SEEN or _PROFILED is None:
        if _PROFILED is not None:
            _PROFILED.close()
        _PROFILED, _OFF_SEEN = Tracer(), False
    return _PROFILED


def span(name: str, *, tile: bool = False, **attrs):
    """A span in the active tracer, else in the profiling session's while
    ``torch.profiler`` records, else the shared null span."""
    if _ACTIVE.active:
        return _ACTIVE.span(name, tile, **attrs)
    if _autograd_profiler._is_profiler_enabled:
        return _profiled_session().span(name, tile, **attrs)
    global _OFF_SEEN
    _OFF_SEEN = True
    return _NULL_SPAN


def metric(name: str, values: Optional[Dict[str, Any]] = None, **attrs):
    return _ACTIVE.metric(name, values, **attrs)


def profiled() -> Optional[Tracer]:
    """The tracer of the profiling session in which spans recorded last,
    until a span meets the profiler off (``None`` then, and before any)."""
    return None if _OFF_SEEN else _PROFILED


def phase_totals() -> Dict[str, Dict[str, Any]]:
    """``profiled().totals()``; ``{}`` when there is no session."""
    tracer = profiled()
    return tracer.totals() if tracer is not None else {}


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
