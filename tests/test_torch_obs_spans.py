"""The spans inside the LM split step and decode step (``repro_torch.obs``).

On the CPU: a span records nothing when neither a tracer nor
``torch.profiler`` records (no event, no clock read, no backward hook);
recorded spans carry ``time.time_ns()`` stamps that contain their
``record_function`` range under the profiler; spans follow the profiler
into a session of its own, fresh for each profiling session; the step's
outputs are bit for bit the same traced and untraced; the leaf spans tile
their step; the device stamps' bookkeeping (read only once complete, a
pool of events, tiling spans sharing a stamp) on a stand-in event.

On the card (marker ``card``; ``python -m pytest -q -m card
tests/test_torch_obs_spans.py``): a traced step calls no
``torch.cuda.synchronize`` and reads nothing back; its stamps are read
after the caller's readback; its leaves' device time is 95-100.5% of the
step's.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.launch import serve_lm as SERVE_LM
from repro_torch.launch import train as TRAIN
from repro_torch.models import lm
from repro_torch.obs import report as PR
from repro_torch.obs import trace as PT
from repro_torch.train import trainer as TR

ROOT = Path(__file__).resolve().parent.parent
TRAIN_LEAVES = ["train.combine", "lm.trunk", "lm.adaptive", "lm.head",
                "lm.head", "train.head_bwd", "train.adaptive_bwd",
                "train.clip", "train.adam"]
# a bf16 or fp32 cache is read in place by the attention; an int8 cache
# is dequantized first, in ``decode.kv_read``
DECODE_LAYER = ["decode.qkv", "decode.attend", "decode.out"]
DECODE_LAYER_INT8 = ["decode.qkv", "decode.kv_read", "decode.attend",
                     "decode.out"]


def _train_setup(arch, device="cpu", seed=0):
    cfg = get_config(arch).reduced()
    st = TR.init_train_state(cfg, torch.Generator(device=device)
                             .manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                        device=device)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    return cfg, st, TR.make_train_step(cfg, tie_lambda=1e-4), batch


def _train_once(setup):
    _, st, step, batch = setup
    return step(st.frozen, st.B, st.trainable, st.opt_state, batch)


def _decode_setup(arch, device="cpu", seed=0, slots=12):
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen,
                        device=device).to(torch.int32)
    return cfg, params, tok, slots


def _decode(setup, steps=3, dtype=torch.float32):
    """``steps`` greedy decode steps from a fresh cache of ``dtype`` ->
    (tokens, cache)."""
    cfg, params, tok, slots = setup
    cache = lm.init_cache(cfg, tok.shape[0], slots, dtype=dtype,
                          device=tok.device)
    out = []
    for pos in range(steps):
        tok, cache = lm.decode_step(cfg, params, cache, tok, pos)
        out.append(tok)
    return torch.cat(out, 1), cache


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _spans(tracer):
    return [e for e in tracer.events if e["kind"] == "span"]


def _steps(spans, step):
    """The spans grouped by step: [(step span, [its leaves in order])]."""
    out, leaves = [], []
    for e in spans:
        if e["name"] == step:
            out.append((e, leaves))
            leaves = []
        else:
            leaves.append(e)
    return out


# ---------------------------------------------------------------------------
# the null path
# ---------------------------------------------------------------------------


class _Clock:
    """Stands in for the ``time`` module in ``obs.trace``: counts reads."""

    def __init__(self):
        self.reads = 0

    def perf_counter(self):
        self.reads += 1
        return time.perf_counter()

    def time_ns(self):
        self.reads += 1
        return time.time_ns()


def test_null_path_makes_no_event_timestamp_or_hook(monkeypatch):
    """Neither a tracer nor the profiler: a train step and a decode step
    take the shared null span, read no clock, make no CUDA event and
    install no backward hook; they end the last profiling session, so
    nothing reads it any more."""
    clock, made, hooks = _Clock(), [], []
    monkeypatch.setattr(PT, "time", clock)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda self, fn: hooks.append(1) or
                        register(self, fn))
    assert not PT.recording()
    assert PT.span("train.step", cat="step") is PT._NULL_SPAN
    assert PT.span("decode.qkv", tile=True) is PT._NULL_SPAN
    _train_once(_train_setup("qwen3-1.7b"))
    _decode(_decode_setup("qwen1.5-0.5b"))
    assert (clock.reads, made, hooks) == (0, [], [])
    assert PT.profiled() is None and PT.phase_totals() == {}


def test_null_span_marks_a_profiling_session_as_ended():
    """A span met with the profiler off ends the profiling session:
    ``profiled()`` gives nothing, and the next span under the profiler
    starts a new one."""
    with PT.span("off"):
        pass
    assert PT.profiled() is None
    with profile(activities=[ProfilerActivity.CPU]):
        with PT.span("a"):
            pass
    first = PT.profiled()
    assert [r[2] for r in first.rows()] == ["a"]
    with PT.span("off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with PT.span("b"):
            pass
    assert PT.profiled() is not first
    assert [r[2] for r in PT.profiled().rows()] == ["b"]
    assert [r[2] for r in first.rows()] == ["a"]
    with PT.span("off"):
        pass
    assert PT.profiled() is None


# ---------------------------------------------------------------------------
# the profiler's clock
# ---------------------------------------------------------------------------


def test_span_stamps_contain_the_record_function_range():
    """Spans under a tracer carry ``t0_ns`` / ``t1_ns`` on the clock
    ``time.time_ns()`` reads; under CPU profiling each contains the
    ``record_function`` range of its name, and ``rows()`` gives them as
    (start ns, end ns, name)."""
    tr = PT.Tracer()
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with PT.active(tr):
            for i in range(20):
                with PT.span(f"outer{i}", cat="step"):
                    with PT.span(f"inner{i}", cat="phase", tile=True):
                        torch.ones(64).sum()
    after = time.time_ns()
    rows = tr.rows()
    assert len(rows) == 40
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("outer", "inner"))}
    assert len(ranges) == 40
    for t0, t1, name in rows:
        assert before <= t0 <= t1 <= after
        lo, hi = ranges[name]
        assert t0 <= lo <= hi <= t1, name
    for e in _spans(tr):
        assert (e["t0_ns"], e["t1_ns"], e["name"]) in rows
        assert "dev" not in e               # the CPU: host times only


# ---------------------------------------------------------------------------
# following the profiler
# ---------------------------------------------------------------------------


def test_profiler_session_holds_one_step_and_its_leaves_in_order():
    """Under ``torch.profiler`` with no tracer active, a reduced split
    step records into the profiling session: one ``train.step`` and its
    leaves in order; a second profiling session, after a step with the
    profiler off, starts empty and holds its own two steps."""
    setup = _train_setup("qwen3-1.7b")
    _train_once(setup)                               # profiler off
    with profile(activities=[ProfilerActivity.CPU]):
        _train_once(setup)
    first = PT.profiled()
    names = [r[2] for r in first.rows()]
    assert names == TRAIN_LEAVES + ["train.step"]
    totals = PT.phase_totals()
    assert totals["train.step"]["count"] == 1
    assert totals["lm.head"]["count"] == 2
    assert all(t["dev_s"] is None for t in totals.values())
    _train_once(setup)                               # profiler off
    with profile(activities=[ProfilerActivity.CPU]):
        _train_once(setup)
        _train_once(setup)
    assert PT.profiled() is not first
    assert [r[2] for r in PT.profiled().rows()] == 2 * names
    assert PT.phase_totals()["train.step"]["count"] == 2
    assert first.totals()["train.step"]["count"] == 1
    assert not PT.is_active()                        # metrics stay off


# ---------------------------------------------------------------------------
# tracing changes nothing the step computes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen1.5-0.5b",
                                  "qwen3-moe-235b-a22b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_train_step_bit_identical_traced_and_untraced(arch):
    """One split step untraced, under a tracer and under the profiler:
    the same new trainables, optimizer state and metrics, bit for bit."""
    setup = _train_setup(arch)
    want = _flat(_train_once(setup))
    tr = PT.Tracer()
    with PT.active(tr):
        traced = _flat(_train_once(setup))
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _flat(_train_once(setup))
    for got in (traced, profiled):
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [e["name"] for e in _spans(tr)][-1] == "train.step"


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen1.5-0.5b",
                                  "qwen3-moe-235b-a22b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_decode_steps_bit_identical_traced_and_untraced(arch):
    """Three decode steps untraced and under a tracer: the same tokens and
    cache, bit for bit."""
    setup = _decode_setup(arch)
    want_tok, want_cache = _decode(setup)
    tr = PT.Tracer()
    with PT.active(tr):
        tok, cache = _decode(setup)
    assert torch.equal(tok, want_tok)
    assert all(torch.equal(a, b) for a, b in zip(_flat(cache),
                                                 _flat(want_cache)))
    steps = _steps(_spans(tr), "decode.step")
    dense = get_config(arch).family in ("dense", "moe")
    assert len(steps) == (3 if dense else 0)


# ---------------------------------------------------------------------------
# the leaves tile the step
# ---------------------------------------------------------------------------


def _assert_tiled(step, leaves):
    assert leaves[0]["t0_ns"] == step["t0_ns"]
    assert leaves[0]["t0"] == step["t0"]
    for a, b in zip(leaves, leaves[1:]):
        assert a["t1_ns"] == b["t0_ns"]
        assert a["t0"] + a["dur"] == b["t0"]
    assert leaves[-1]["t1_ns"] <= step["t1_ns"]
    assert all(e.get("cat") == "phase" for e in leaves)
    assert step.get("cat") == "step"


def test_train_leaves_tile_the_step():
    """Two traced split steps: each ``train.step`` is partitioned by its
    leaves, in order, each starting on the stamp where the last ended."""
    setup = _train_setup("qwen3-1.7b")
    tr = PT.Tracer()
    with PT.active(tr):
        _train_once(setup)
        _train_once(setup)
    steps = _steps(_spans(tr), "train.step")
    assert len(steps) == 2
    for step, leaves in steps:
        assert [e["name"] for e in leaves] == TRAIN_LEAVES
        _assert_tiled(step, leaves)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-1.7b"])
def test_decode_leaves_tile_the_step(arch):
    """Three traced decode steps: each ``decode.step`` is partitioned by
    three leaves a layer and ``decode.head``."""
    setup = _decode_setup(arch)
    tr = PT.Tracer()
    with PT.active(tr):
        _decode(setup)
    steps = _steps(_spans(tr), "decode.step")
    assert len(steps) == 3
    n_layers = setup[0].n_layers
    for step, leaves in steps:
        assert [e["name"] for e in leaves] == \
            DECODE_LAYER * n_layers + ["decode.head"]
        _assert_tiled(step, leaves)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-1.7b"])
def test_int8_decode_leaves_open_kv_read(arch):
    """An int8 cache's steps keep the dequantize in ``decode.kv_read``:
    four leaves a layer, tiled."""
    setup = _decode_setup(arch)
    tr = PT.Tracer()
    with PT.active(tr):
        _decode(setup, dtype=torch.int8)
    steps = _steps(_spans(tr), "decode.step")
    assert len(steps) == 3
    for step, leaves in steps:
        assert [e["name"] for e in leaves] == \
            DECODE_LAYER_INT8 * setup[0].n_layers + ["decode.head"]
        _assert_tiled(step, leaves)


# ---------------------------------------------------------------------------
# device stamps, on a stand-in for CUDA events
# ---------------------------------------------------------------------------


class _FakeStream:
    """A stream whose work completes when the test says so: events record
    a position in it, and are complete once ``done`` reaches it."""

    def __init__(self):
        self.pos, self.done, self.made, self.waits = 0, 0, 0, 0

    def event_class(self):
        stream = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                stream.made += 1
                self.at = None

            def record(self):
                stream.pos += 1
                self.at = stream.pos

            def query(self):
                return self.at <= stream.done

            def synchronize(self):
                stream.waits += 1
                stream.done = max(stream.done, self.at)

            def elapsed_time(self, end):
                assert self.query() and end.query()
                return float(end.at - self.at)        # ms

        return Event


def test_device_stamps_are_read_once_complete_from_a_pool(monkeypatch):
    """With CUDA in use (stood in for), a span takes a device stamp at each
    boundary, a tiling span shares its sibling's; nothing is read while
    the events are incomplete and nothing waits; the next root span reads
    what completed; events go back to a pool, so later steps make none;
    ``close()`` reads the rest."""
    stream = _FakeStream()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", stream.event_class())
    tr = PT.Tracer()

    def step():
        with tr.span("s", cat="step"):
            for name in ("a", "b", "c"):
                with tr.span(name, cat="phase", tile=True):
                    pass

    step()
    assert stream.pos == 5          # s, a..c shared: 1 + 3 ends + s's end
    assert len(tr._pending) == 4 and stream.waits == 0
    step()                          # first step incomplete: nothing read
    assert len(tr._pending) == 8
    assert all("dev" not in e for e in tr._events if e["kind"] == "span")
    stream.done = stream.pos        # the caller's readback
    step()
    evs = [e for e in tr._events if e["kind"] == "span"]
    assert [e.get("dev") for e in evs[:8]] == [1e-3, 1e-3, 1e-3, 4e-3] * 2
    assert all("dev" not in e for e in evs[8:])
    made = stream.made
    stream.done = stream.pos
    for _ in range(5):
        step()
        stream.done = stream.pos
    assert stream.made == made and stream.waits == 0
    tr.close()
    assert stream.waits == 1 and not tr._pending
    totals = tr.totals()
    assert totals["a"]["count"] == 8
    assert totals["s"]["dev_s"] == pytest.approx(8 * 4e-3)


def test_a_first_tiling_child_starts_on_its_parent_stamp(monkeypatch):
    """A tiling span starts where its parent began or its sibling ended;
    one that is not tiling, or a root, takes a stamp of its own."""
    stream = _FakeStream()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", stream.event_class())
    tr = PT.Tracer()
    with tr.span("root", tile=True):
        with tr.span("own"):
            pass
        with tr.span("next", tile=True):
            pass
    assert stream.pos == 5
    tr.close()
    dev = {e["name"]: e["dev"] for e in tr.events if e["kind"] == "span"}
    assert dev == {"own": 1e-3, "next": 1e-3, "root": 4e-3}


# ---------------------------------------------------------------------------
# the reporter and the launchers
# ---------------------------------------------------------------------------


def test_report_gives_device_ms_beside_host_ms(capsys):
    """Spans that carry ``dev`` get device totals and means in their
    group and a column in the printed table; spans without keep the
    reference's group dict."""
    events = [{"kind": "span", "name": "decode.step", "cat": "step",
               "t0": 0.0, "dur": 0.2, "dev": 0.15},
              {"kind": "span", "name": "decode.attend", "cat": "phase",
               "t0": 0.0, "dur": 0.1, "dev": 0.05},
              {"kind": "span", "name": "decode.attend", "cat": "phase",
               "t0": 0.1, "dur": 0.1, "dev": 0.07},
              {"kind": "span", "name": "round.eval", "cat": "phase",
               "t0": 0.2, "dur": 0.1}]
    g = PR._span_groups(events, "phase")
    assert g["decode.attend"]["dev_total_s"] == pytest.approx(0.12)
    assert g["decode.attend"]["dev_mean_s"] == pytest.approx(0.06)
    assert set(g["round.eval"]) == {"total_s", "count", "max_s", "mean_s",
                                    "share"}
    PR._print_groups("phases", g)
    PR._print_groups("steps", PR._span_groups(events, "step"))
    out = capsys.readouterr().out
    assert "dev ms" in out and "120.00" in out and "150.00" in out


def test_train_launcher_trace_on_cpu(tmp_path, capsys):
    """``launch/train.py --trace`` writes a span per step and per phase;
    the reporter prints the steps and the phases."""
    path = tmp_path / "train.jsonl"
    losses = TRAIN.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--trace", str(path)])
    assert len(losses) == 3 and not PT.is_active()
    assert f"telemetry: {path}" in capsys.readouterr().out
    events = PT.RunLog.read(path)
    steps = _steps([e for e in events if e["kind"] == "span"], "train.step")
    assert len(steps) == 3
    assert all([e["name"] for e in leaves] == TRAIN_LEAVES
               for _, leaves in steps)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    text = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                           str(path)], capture_output=True, text=True,
                          env=env, timeout=120, check=True).stdout
    assert "steps" in text and "train.step" in text and "lm.head" in text


def test_serve_lm_launcher_trace_on_cpu(tmp_path, capsys):
    """``launch/serve_lm.py --trace`` writes a ``decode.step`` span a
    step; the summary's phases are the decode phases."""
    path = tmp_path / "serve_lm.jsonl"
    gen = SERVE_LM.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                         "3", "--gen", "4", "--trace", str(path)])
    assert gen.shape == (2, 4) and not PT.is_active()
    assert f"telemetry: {path}" in capsys.readouterr().out
    events = PT.RunLog.read(path)
    names = [e["name"] for e in events if e["kind"] == "span"]
    assert names.count("decode.step") == 3 + 4 - 1
    summary = PR.summarize(events)
    assert set(summary["phases"]) == set(DECODE_LAYER) | {"decode.head"}
    json.dumps(summary)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


class _Readbacks(TorchDispatchMode):
    """Counts the ops that read a CUDA tensor back to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cuda_in = any(isinstance(a, torch.Tensor) and a.is_cuda
                      for a in list(args) + list(kwargs.values()))
        to_host = any(isinstance(o, torch.Tensor) and not o.is_cuda
                      for o in (out if isinstance(out, (list, tuple))
                                else [out]))
        if func is torch.ops.aten._local_scalar_dense.default or (
                cuda_in and to_host):
            self.n += 1
        return out


@pytest.mark.card
def test_traced_step_neither_synchronizes_nor_reads_back(card,
                                                         monkeypatch):
    """A traced split step and decode step on the card call
    ``torch.cuda.synchronize`` never and read back as many tensors as
    untraced (none)."""
    calls = []
    sync = torch.cuda.synchronize
    train = _train_setup("qwen3-1.7b", device=card)
    dec = _decode_setup("qwen1.5-0.5b", device=card)
    _train_once(train)
    _decode(dec, steps=1)
    sync()
    counts = {}
    for traced in (False, True):
        tr = PT.Tracer()
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a, **k: calls.append(traced))
        with PT.active(tr) if traced else PT.suspended(), \
                _Readbacks() as rb:
            _train_once(train)
            _train_once(train)
            _decode(dec, steps=2)
        monkeypatch.setattr(torch.cuda, "synchronize", sync)
        counts[traced] = rb.n
        sync()
        tr.close()
    assert calls == []
    assert counts == {False: 0, True: 0}
    spans = _spans(tr)
    assert spans and all("dev" in e for e in spans)


@pytest.mark.card
def test_device_stamps_resolve_after_the_callers_readback(card):
    """The first step's spans stay pending while it runs; after the
    caller's readback the next step's entry reads their device time."""
    setup = _train_setup("qwen3-1.7b", device=card)
    _train_once(setup)
    torch.cuda.synchronize()
    tr = PT.Tracer()
    with PT.active(tr):
        m = _train_once(setup)[2]
        n = len(tr._pending)
        assert n == len(TRAIN_LEAVES) + 1
        float(m["loss"])                        # the caller's readback
        _train_once(setup)
        first = [e for e in tr._events if e["kind"] == "span"][:n]
        assert all(e["dev"] > 0 for e in first)
    torch.cuda.synchronize()
    tr.close()


@pytest.mark.card
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_leaf_device_time_is_95_to_100_5_percent_of_the_step(card, kind):
    """Each traced step's leaves sum to 95-100.5% of its device time."""
    if kind == "train":
        setup = _train_setup("qwen3-1.7b", device=card)
        run, name = (lambda: _train_once(setup)), "train.step"
    else:
        setup = _decode_setup("qwen1.5-0.5b", device=card, slots=64)
        run, name = (lambda: _decode(setup, steps=8)), "decode.step"
    run()
    torch.cuda.synchronize()
    tr = PT.Tracer()
    with PT.active(tr):
        run()
        run()
    tr.close()
    steps = _steps(_spans(tr), name)
    assert steps
    for step, leaves in steps:
        share = sum(e["dev"] for e in leaves) / step["dev"]
        assert 0.95 <= share <= 1.005, (name, share)
