"""Lint CLI: trace every registered program on meta tensors, run all
passes, report (the port of ``repro/analysis/lint.py``).

    PYTHONPATH=src python -m repro_torch.analysis.lint [--program NAME] [--json]

Exit status 0 iff every finding is covered by the baseline
(``analysis/baseline.json``) and no suppression is stale. The baseline is
a suppression list, not a bug tracker: every entry carries a ``reason``
saying why the finding is accepted, and entries that no longer match
anything are reported as stale (so fixes retire their suppressions).

Baseline entry shape::

    {"code": "dead-code", "program": "federated.stacked_eval",
     "match": "substring of the finding message (optional)",
     "reason": "why this is accepted"}

``--program NAME`` restricts to one program's trace lints (skipping the
repo-wide convention passes); ``--json`` emits the machine-readable
report. The sharded programs trace in a fake world of one
(``launch.mesh.fake_world``), and a process holds one default group: run
the full lint in a process that holds none.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis import conventions, lints, registry
from repro_torch.analysis.lints import Finding

BASELINE_PATH = Path(__file__).with_name("baseline.json")


def load_baseline(path: Path) -> List[Dict]:
    if not path.exists():
        return []
    return json.loads(path.read_text())["suppressions"]


def partition_findings(findings: List[Finding], suppressions: List[Dict]
                       ) -> Tuple[List[Finding], List[Finding], List[Dict]]:
    """-> (new findings, baselined findings, stale suppressions)."""
    hit = [False] * len(suppressions)
    new, base = [], []
    for f in findings:
        matched = False
        for i, s in enumerate(suppressions):
            if (s["code"] == f.code and s["program"] == f.program
                    and s.get("match", "") in f.message):
                hit[i] = matched = True
        (base if matched else new).append(f)
    stale = [s for i, s in enumerate(suppressions) if not hit[i]]
    return new, base, stale


def run(program: str = None) -> Dict:
    """Trace + lint -> the full report dict (the CLI's --json payload)."""
    specs = registry.iter_programs()
    if program is not None:
        specs = [registry.get_program(program)]
    findings: List[Finding] = []
    programs: Dict[str, Dict] = {}
    for spec in specs:
        try:
            tr = registry.trace(spec)
        except Exception as e:                              # noqa: BLE001
            findings.append(Finding(
                "untraceable", spec.name,
                f"abstract trace failed: {e!r:.200}"))
            programs[spec.name] = {"traced": False}
            continue
        fs, stats = lints.run_jaxpr_lints(tr, spec)
        findings.extend(fs)
        programs[spec.name] = {"traced": True, **stats}
    if program is None:
        findings.extend(conventions.run_convention_lints(
            conventions.repo_root(), specs))
    return {"programs": programs, "findings": findings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.lint")
    ap.add_argument("--program", default=None,
                    help="lint one registered program (trace passes only)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--baseline", type=Path, default=BASELINE_PATH)
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding (ignore suppressions)")
    args = ap.parse_args(argv)

    report = run(args.program)
    suppressions = [] if args.no_baseline else load_baseline(args.baseline)
    new, base, stale = partition_findings(report["findings"], suppressions)

    traced = [n for n, p in report["programs"].items() if p["traced"]]
    if args.as_json:
        print(json.dumps({
            "programs_registered": len(report["programs"]),
            "programs_traced": len(traced),
            "programs": report["programs"],
            "findings": [f.as_dict() for f in new],
            "baselined": [f.as_dict() for f in base],
            "stale_suppressions": stale,
        }, indent=2))
    else:
        print(f"traced {len(traced)}/{len(report['programs'])} "
              f"registered programs")
        for name in sorted(report["programs"]):
            p = report["programs"][name]
            if p["traced"]:
                print(f"  {name:45s} {p['ops']:5d} ops   "
                      f"peak~{p['peak_bytes'] / 1e6:8.1f} MB")
            else:
                print(f"  {name:45s} TRACE FAILED")
        for f in new:
            print(f"FINDING [{f.code}] {f.program}: {f.message}")
        for s in stale:
            print(f"STALE SUPPRESSION [{s['code']}] {s['program']}: "
                  f"{s.get('reason', '')}")
        print(f"{len(new)} finding(s), {len(base)} baselined, "
              f"{len(stale)} stale suppression(s)")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
