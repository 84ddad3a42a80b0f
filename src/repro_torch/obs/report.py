"""Run reporter: summarize a telemetry JSONL into where-the-time-went.

The port of ``repro/obs/report.py``. Usage::

    python -m repro_torch.obs.report run.jsonl            # human-readable
    python -m repro_torch.obs.report run.jsonl --json     # machine-readable
    python -m repro_torch.obs.report run.jsonl --chrome trace.json

The summary has three sections: a per-phase wall-time breakdown (spans
tagged ``cat="phase"`` — a round's gather / local_train / encode / server /
apply / eval, or an LM step's phases — plus the ``cat="stage"`` sub-spans
inside the server round; device time beside host time where the spans
carry it), a per-client table from the LAST round's device metrics
(staleness, ring fill, relevance row mass/density, codec keep-rate and
residual-norm), and the serving snapshot (bucket-exact p50/p99, QPS,
queue depth, DRR deficit spread) if the run served queries.
``telemetry_block()`` is the same data without the per-client tables.
The printed report adds the ``cat="step"`` spans (an LM step around its
phases) as a table of its own.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs.trace import RunLog, chrome_trace


def _span_groups(events: List[Dict[str, Any]], cat: str) -> Dict[str, Dict]:
    """Spans of category ``cat`` by name: host seconds (total, count, max,
    mean, share of the category's total) and, where the spans carry a
    device time, ``dev_total_s`` and ``dev_mean_s``."""
    groups: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.get("kind") == "span" and e.get("cat") == cat:
            g = groups.setdefault(e["name"], {"total_s": 0.0, "count": 0,
                                              "max_s": 0.0})
            g["total_s"] += e["dur"]
            g["count"] += 1
            g["max_s"] = max(g["max_s"], e["dur"])
            if "dev" in e:
                g["dev_total_s"] = g.get("dev_total_s", 0.0) + e["dev"]
    total = sum(g["total_s"] for g in groups.values())
    for g in groups.values():
        g["mean_s"] = g["total_s"] / g["count"]
        g["share"] = g["total_s"] / total if total > 0 else 0.0
        if "dev_total_s" in g:
            g["dev_mean_s"] = g["dev_total_s"] / g["count"]
    return groups


def _last_metric(events: List[Dict[str, Any]],
                 name: str) -> Optional[Dict[str, Any]]:
    for e in reversed(events):
        if e.get("kind") == "metric" and e.get("name") == name:
            return e
    return None


def summarize(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Events (from ``Tracer.events`` or ``RunLog.read``) -> summary dict."""
    events = list(events)
    phases = _span_groups(events, "phase")
    stages = _span_groups(events, "stage")

    clients: Dict[str, Any] = {}
    rel = _last_metric(events, "server.relevance")
    if rel:
        clients.update(rel.get("values", {}))
        clients["round"] = rel.get("round")
    enc = _last_metric(events, "comm.encode")
    if enc:
        for k, v in enc.get("values", {}).items():
            clients[k] = v

    serve = _last_metric(events, "serve.stats")
    ivf = _last_metric(events, "serve.ivf")

    n_spans = sum(1 for e in events if e.get("kind") == "span")
    n_metrics = sum(1 for e in events if e.get("kind") == "metric")
    return {
        "events": {"spans": n_spans, "metrics": n_metrics,
                   "total": len(events)},
        "phases": phases,
        "stages": stages,
        "clients": clients,
        "serve": serve.get("values") if serve else None,
        "ivf": ivf.get("values") if ivf else None,
    }


def telemetry_block(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """The fleet-level ``telemetry`` block of a run: the span breakdown
    without the per-client tables (those stay in the JSONL)."""
    s = summarize(events)
    block: Dict[str, Any] = {"events": s["events"], "phases": s["phases"],
                             "stages": s["stages"]}
    if s["serve"]:
        block["serve"] = s["serve"]
    return block


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:9.2f}"


def _print_groups(title: str, groups: Dict[str, Dict]) -> None:
    """A table of span groups: host ms, and device ms beside it where the
    group's spans carry it."""
    if not groups:
        return
    dev = any("dev_total_s" in g for g in groups.values())
    print(f"\n{title}")
    print(f"  {'name':<28} {'total ms':>9} {'mean ms':>9} "
          f"{'count':>6} {'share':>6}"
          + (f" {'dev ms':>9} {'dev mean':>9}" if dev else ""))
    for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["total_s"]):
        line = (f"  {name:<28} {_fmt_ms(g['total_s'])} {_fmt_ms(g['mean_s'])} "
                f"{g['count']:>6} {g['share'] * 100:5.1f}%")
        if "dev_total_s" in g:
            line += f" {_fmt_ms(g['dev_total_s'])} {_fmt_ms(g['dev_mean_s'])}"
        print(line)


def _print_clients(clients: Dict[str, Any]) -> None:
    cols = [c for c in ("staleness", "hist_fill", "row_mass", "row_density",
                        "self_weight", "keep_rate", "residual_norm")
            if isinstance(clients.get(c), list)]
    if not cols:
        return
    n = len(clients[cols[0]])
    rnd = clients.get("round")
    print(f"\nper-client (last round{'' if rnd is None else f' {rnd}'})")
    print("  " + f"{'client':>6} " + " ".join(f"{c:>13}" for c in cols))
    for i in range(n):
        row = " ".join(f"{clients[c][i]:13.4f}" for c in cols)
        print(f"  {i:>6} {row}")


def _print_serve(serve: Dict[str, Any]) -> None:
    print("\nserving")
    for key in ("latency", "queue", "service"):
        h = serve.get(key)
        if h:
            print(f"  {key:<8} n={h['n']:<7} mean={h['mean_s'] * 1e3:8.3f}ms"
                  f"  p50={h['p50_s'] * 1e3:8.3f}ms"
                  f"  p99={h['p99_s'] * 1e3:8.3f}ms")
    print(f"  completed={serve.get('completed')} "
          f"launches={serve.get('launches')} "
          f"queue_depth(mean/max)={serve.get('queue_depth', {}).get('mean'):.1f}"
          f"/{serve.get('queue_depth', {}).get('max')}")
    if "drr_deficit_spread" in serve:
        print(f"  drr deficit spread={serve['drr_deficit_spread']:.1f}")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a telemetry JSONL written by repro_torch.obs.")
    p.add_argument("path", help="telemetry JSONL (from --trace / RunLog)")
    p.add_argument("--json", action="store_true",
                   help="print the summary as JSON instead of a table")
    p.add_argument("--chrome", metavar="OUT",
                   help="also write a Chrome-trace/Perfetto JSON to OUT")
    args = p.parse_args(argv)

    events = RunLog.read(args.path)
    s = summarize(events)

    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(chrome_trace(events), f)
        print(f"chrome trace -> {args.chrome}", file=sys.stderr)

    if args.json:
        print(json.dumps(s, indent=2))
        return 0

    print(f"{args.path}: {s['events']['spans']} spans, "
          f"{s['events']['metrics']} metrics")
    _print_groups("steps", _span_groups(events, "step"))
    _print_groups("phases", s["phases"])
    _print_groups("server stages", s["stages"])
    _print_clients(s["clients"])
    if s["serve"]:
        _print_serve(s["serve"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
