"""The port's telemetry (repro_torch.obs) against the JAX package's
(repro.obs) on the same inputs, on the CPU.

The tracer keeps the reference's contract: the null path records nothing
and its ``sync`` is the identity; ``active`` restores the previous tracer;
events go to the same JSONL schema, which either package's ``RunLog``
reads, and the reporter (``summarize``, ``telemetry_block``,
``chrome_trace``) gives equal dicts on the same events; the port's spans
add their stamps on the profiler's clock (``t0_ns``, ``t1_ns``), timing
fields like ``t0`` and ``dur``. ``relevance_metrics`` agrees with the JAX
function within 1e-6 on seeded numpy inputs. ``launch/serve.py
--trace`` writes a JSONL that ``python -m repro_torch.obs.report`` reads.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import metrics as JM
from repro.obs import report as JR
from repro.obs import trace as JT
from repro_torch import obs
from repro_torch.core import edge_model as EM
from repro_torch.core.fedstil import FedSTIL
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated import run_simulation
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import metrics as PM
from repro_torch.obs import report as PR
from repro_torch.obs import trace as PT

ROOT = Path(__file__).resolve().parent.parent
TIMING = ("t0", "dur", "epoch", "t0_ns", "t1_ns")


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in TIMING} for e in events]


def _record(T, values, path=None):
    """The same spans and metrics through package ``T``'s tracer (writing
    ``path`` when given); ``values(i)`` gives the i-th metric's value dict
    in that package's array type."""
    tr = T.Tracer(path)
    with T.active(tr):
        with T.span("round.local_train", cat="phase", round=0):
            pass
        with T.span("round.server", cat="phase", round=0) as sp:
            with T.span("server.relevance", cat="stage", round=0):
                pass
            sp.sync(values(0)["staleness"])
        T.metric("server.relevance", values(0), round=0)
        with T.span("comm.upload", cat="codec"):
            pass
        T.metric("comm.encode", {"keep_rate": values(1)["row_mass"]},
                 direction="upload")
        with T.span("round.encode", cat="phase", round=1):
            pass
        T.metric("server.relevance", values(2), round=1)
        T.metric("serve.stats", {"completed": 3, "launches": 1,
                                 "queue_depth": {"mean": 1.0, "max": 2}})
    return tr


def _values(i, as_array):
    rng = np.random.default_rng(i)
    vals = {"staleness": rng.integers(0, 4, 5).astype(np.float32),
            "row_mass": rng.random(5).astype(np.float32),
            "scalar": np.float32(i + 0.5), "flag": True, "note": "x",
            "nested": {"hits": rng.integers(0, 9, (2, 3))}}
    return {k: (as_array(v) if isinstance(v, np.ndarray) else v)
            for k, v in vals.items()}


def _both_tracers(tmp_path=None):
    """(port tracer, reference tracer) over the same events; with
    ``tmp_path`` each also writes port.jsonl / ref.jsonl there."""
    path = (lambda name: None) if tmp_path is None else (
        lambda name: tmp_path / f"{name}.jsonl")
    port = _record(PT, lambda i: _values(i, torch.from_numpy), path("port"))
    ref = _record(JT, lambda i: _values(i, np.asarray), path("ref"))
    return port, ref


# ---------------------------------------------------------------------------
# tracer: null path, activation, JSONL round trip, Chrome trace
# ---------------------------------------------------------------------------


def test_null_tracer_records_nothing_and_sync_is_identity():
    """No tracer active: no events, ``sync`` returns its argument as is
    (both packages); with one active, a CPU tensor's ``sync`` is the
    identity too (nothing to wait for)."""
    sentinel = object()
    for T in (PT, JT):
        assert not T.is_active()
        with T.span("x", cat="phase") as sp:
            assert sp.sync(sentinel) is sentinel
        assert T.metric("x", {"a": 1.0}) is None
    assert PT.get_tracer().span("x") is PT._NULL_SPAN
    x = {"a": torch.zeros(3), "b": [torch.ones(2), 1.0]}
    tr = PT.Tracer()
    with PT.active(tr):
        with PT.span("y") as sp:
            assert sp.sync(x) is x
    assert [e["kind"] for e in tr.events] == ["meta", "span"]


def test_active_tracer_restores_previous_on_exit():
    tr, outer = PT.Tracer(), PT.Tracer()
    with PT.active(outer):
        with PT.active(tr):
            assert PT.is_active() and PT.get_tracer() is tr
            with PT.suspended():
                assert not PT.is_active()
            assert PT.get_tracer() is tr
        assert PT.get_tracer() is outer
    assert not PT.is_active()
    PT.activate(tr)
    try:
        assert PT.get_tracer() is tr
    finally:
        PT.deactivate()
    assert not PT.is_active() and obs.get_tracer() is PT._NULL


def test_span_and_metric_events_jsonl_round_trip(tmp_path):
    """The same spans and metrics, tensors in the port and numpy in the
    reference: equal untimed events in memory and on disk, whichever
    package's ``RunLog.read`` parses either file."""
    port, ref = _both_tracers(tmp_path)
    assert _untimed(port.events) == _untimed(ref.events)
    port.close()
    ref.close()
    want = _untimed(ref.events)
    for path in (tmp_path / "port.jsonl", tmp_path / "ref.jsonl"):
        for read in (PT.RunLog.read, JT.RunLog.read):
            assert _untimed(read(path)) == want
    met = next(e for e in port.events if e["kind"] == "metric")
    assert met["values"]["staleness"] == _values(0, list)["staleness"]
    assert met["values"]["scalar"] == 0.5
    assert all(e["dur"] >= 0.0 for e in port.events if e["kind"] == "span")


def test_tracer_with_a_path_writes_on_close_only(tmp_path):
    path = tmp_path / "run.jsonl"
    tr = PT.Tracer(path)
    with PT.active(tr):
        with PT.span("a", cat="stage"):
            pass
    assert not path.exists()
    tr.close()
    assert [e["kind"] for e in PT.RunLog.read(path)] == ["meta", "span"]


def test_chrome_trace_export():
    """Equal Chrome traces of the same events through both packages;
    spans become "X" events on their category's track, metrics "i"."""
    port, _ = _both_tracers()
    ct = PT.chrome_trace(port.events)
    assert ct == JT.chrome_trace(port.events)
    phs = [e["ph"] for e in ct["traceEvents"]]
    assert phs.count("X") == 5 and phs.count("i") == 4
    x = next(e for e in ct["traceEvents"] if e["name"] == "server.relevance"
             and e["ph"] == "X")
    assert x["tid"] == "stage" and x["dur"] >= 0.0 and x["ts"] >= 0.0
    json.dumps(ct)


# ---------------------------------------------------------------------------
# report aggregation
# ---------------------------------------------------------------------------


def test_summarize_and_telemetry_block():
    """The same event list through both packages' ``summarize`` and
    ``telemetry_block``: equal dicts; the last round's relevance metrics
    win the per-client table."""
    port, ref = _both_tracers()
    for events in (port.events, ref.events):
        s = PR.summarize(events)
        assert s == JR.summarize(events)
        assert PR.telemetry_block(events) == JR.telemetry_block(events)
    s = PR.summarize(port.events)
    assert set(s["phases"]) == {"round.local_train", "round.server",
                                "round.encode"}
    assert abs(sum(g["share"] for g in s["phases"].values()) - 1.0) < 1e-9
    assert s["clients"]["round"] == 1
    assert s["clients"]["staleness"] == _values(2, list)["staleness"]
    assert s["clients"]["keep_rate"] == _values(1, list)["row_mass"]
    block = PR.telemetry_block(port.events)
    assert block["events"] == {"spans": 5, "metrics": 4, "total": 10}
    assert block["serve"]["completed"] == 3
    json.dumps(block)


def test_port_run_jsonl_reads_through_the_reference_reporter(tmp_path):
    """``run_simulation(trace=path)`` writes the JSONL and closes it; the
    reference's ``RunLog.read`` parses it and its ``summarize`` gives the
    port's summary; the CLI prints the phase table."""
    pb = FederatedReIDBenchmark(n_clients=3, n_tasks=2, n_identities=40,
                                ids_per_task=10, samples_per_id=8, seed=0)
    path = tmp_path / "run.jsonl"
    run_simulation(FedSTIL(EM.EdgeModelConfig(n_classes=pb.n_classes),
                           n_clients=3, epochs=1, codec="delta+topk"),
                   pb, rounds=2, eval_every=2, engine="stacked",
                   device="cpu", trace=str(path))
    assert not obs.is_active()
    events = JT.RunLog.read(path)
    assert events == PT.RunLog.read(path)
    assert events[1] == {"kind": "meta", "kind_detail": "run_simulation",
                         "engine": "stacked", "rounds": 2, "n_clients": 3,
                         "strategy": "fedstil"}
    s = PR.summarize(events)
    assert s == JR.summarize(events)
    assert set(s["phases"]) == {"round.gather", "round.local_train",
                                "round.encode", "round.server",
                                "round.apply", "round.eval"}
    assert set(s["stages"]) == {"server.relevance", "server.flatten",
                                "server.aggregate", "server.unflatten"}
    assert len(s["clients"]["staleness"]) == 3
    assert len(s["clients"]["keep_rate"]) == 3
    chrome = tmp_path / "t.json"
    assert PR.main([str(path), "--chrome", str(chrome)]) == 0
    assert json.loads(chrome.read_text()) == PT.chrome_trace(events)


# ---------------------------------------------------------------------------
# device metrics against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_relevance_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    C, k = 7, 6
    W = np.maximum(rng.standard_normal((C, C)), 0.0).astype(np.float32)
    W[2] = 0.0                                        # a dead row
    valid = (rng.random((C, k)) < 0.6).astype(np.float32)
    stale = rng.integers(0, 5, C).astype(np.float32)
    got = PM.relevance_metrics(torch.from_numpy(W), torch.from_numpy(valid),
                               torch.from_numpy(stale))
    want = JM.relevance_metrics(W, valid, stale)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-6, err_msg=key)


def test_relevance_metrics_values():
    m = PM.relevance_metrics(torch.tensor([[0.0, 1.0], [0.5, 0.5]]),
                             torch.tensor([[1.0, 0.0], [1.0, 1.0]]),
                             torch.tensor([2.0, 0.0]))
    m = {k: v.tolist() for k, v in m.items()}
    assert m == {"row_mass": [1.0, 1.0], "row_density": [0.5, 1.0],
                 "self_weight": [0.0, 0.5], "hist_fill": [1.0, 2.0],
                 "staleness": [2.0, 0.0]}


# ---------------------------------------------------------------------------
# the serve launcher traced
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "ivf"])
def test_serve_launcher_trace_on_cpu(mode, tmp_path, capsys):
    """``launch/serve.py --trace`` at a small gallery: the JSONL holds the
    batches, the refresh, the serve stats and (ivf) the probe metrics, and
    ``python -m repro_torch.obs.report`` summarizes it."""
    path = tmp_path / f"serve_{mode}.jsonl"
    out = serve_cli.main(["--device", "cpu", "--clients", "2", "--gallery",
                          "512", "--queries", "16", "--batch", "4", "--mode",
                          mode, "--nprobe", "4", "--trace", str(path)])
    assert not obs.is_active()
    assert out["pre"]["n"] == out["post"]["n"] == 8
    assert f"telemetry: {path}" in capsys.readouterr().out
    events = PT.RunLog.read(path)
    names = {e.get("name") for e in events}
    want = {"serve.batch", "serve.index_refresh", "serve.stats"}
    assert want <= names and (("serve.ivf" in names) == (mode == "ivf"))
    refresh = next(e for e in events if e.get("name") == "serve.index_refresh")
    assert refresh["mode"] == mode and refresh["cat"] == "serve"
    batches = [e for e in events if e.get("name") == "serve.batch"]
    assert sum(e["slots"] for e in batches) == 17     # warm-up + 16
    stats = next(e for e in events if e.get("name") == "serve.stats")
    assert stats["values"]["completed"] == 17 and stats["mode"] == mode
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    rep = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          str(path), "--json"], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    summary = json.loads(rep.stdout)
    assert summary == json.loads(json.dumps(PR.summarize(events)))
    assert summary["serve"]["completed"] == 17
    if mode == "ivf":
        hits = summary["ivf"]["probe_hits"]
        assert np.asarray(hits).shape == (2, 4)
    text = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                           str(path)], capture_output=True, text=True,
                          env=env, timeout=120, check=True).stdout
    assert "serving" in text and "p99=" in text
