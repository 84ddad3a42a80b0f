"""Trace lint passes: the port's measured invariants, checked on meta
tensors (the port of ``repro/analysis/lints.py``).

Each pass reads a ``registry.Trace`` (the program run once on its meta
inputs under the recording dispatch mode: no data, no device) and returns
``Finding`` records:

  * ``dtype-widen``     a tensor dtype outside the program's declared set
    (default: the wire / compute dtypes bf16 / int8 / f32 plus the index
    and mask types, int64 among them); f64 / complex creep fails here
    before it ever doubles a buffer.
  * ``convert-churn``   an ``aten._to_copy`` A -> B whose output feeds an
    ``aten._to_copy`` straight back to A (wasted casts that usually mark an
    accidental promotion being papered over), unless both legs are in the
    program's ``sanctioned_casts``.
  * ``host-transfer``   a device-to-host sync: ``.item()`` / ``bool(t)``
    (``aten._local_scalar_dense``), an op whose output shape depends on
    the data (``nonzero``, boolean-mask indexing, ``unique``,
    ``masked_select``), a copy to the CPU, or a blocking copy from it. On
    meta the ones that need data end the trace where they stand. torch has
    no host callbacks: this pass is also the reference's
    ``host-callback``. ``allow_syncs=True`` silences it.
  * ``undonated-carry`` a declared round-carried input the program does not
    donate (the declaration), or a donated input that does not come back
    updated in place (no output shares its storage): at C >> 1000 the
    stacked (C, ...) state doubles in memory every round.
  * ``dead-code``       pure ops whose outputs reach neither a program
    output nor an op that writes a tensor (ops that write one are effects,
    always live).
  * ``peak-bytes``      the counter's peak live bytes of the storages the
    program makes (``sharding.analysis.OpCounter``, the production
    lowering's count) above the program's declared budget.

``run_jaxpr_lints`` (the reference's name) runs every pass and returns the
findings and the program's stats (peak bytes, op count) for the CLI.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.registry import ProgramSpec, Trace


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str            # lint pass id, e.g. "dtype-widen"
    program: str         # registered program name, or "<repo>" for AST lints
    message: str

    def as_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------


def lint_dtypes(tr: Trace, spec: ProgramSpec) -> List[Finding]:
    """Flag any tensor dtype outside the program's allowed set, at its
    first op and site."""
    seen: Dict[str, str] = {}
    for _, dt in tr.inputs:
        if dt not in spec.allowed_dtypes:
            seen.setdefault(dt, "program input")
    for op in tr.ops:
        for _, dt in op.outs:
            if dt not in spec.allowed_dtypes:
                seen.setdefault(dt, f"`{op.name}` -> {dt} at {op.site}")
    return [Finding("dtype-widen", spec.name,
                    f"dtype {name} outside allowed "
                    f"{sorted(spec.allowed_dtypes)}: first at {ctx}")
            for name, ctx in sorted(seen.items())]


def lint_convert_churn(tr: Trace, spec: ProgramSpec) -> List[Finding]:
    """Flag A -> B -> A ``_to_copy`` round-trips. A round-trip whose BOTH
    legs are in ``spec.sanctioned_casts`` (the sharded engine's f32 -> bf16
    wire cast and its upcast, ``common/precision.py``) is a declared
    precision boundary, not churn, and is skipped."""
    out: List[Finding] = []
    produced: Dict[int, str] = {}        # cast output storage -> source dtype
    for op in tr.ops:
        if op.name != "aten._to_copy" or not op.ins or not op.outs:
            continue
        (src, mid), (dst, to) = op.ins[0], op.outs[0]
        if src in produced and to == produced[src] and to != mid:
            orig = produced[src]
            if not {(orig, mid), (mid, orig)} <= spec.sanctioned_casts:
                out.append(Finding(
                    "convert-churn", spec.name,
                    f"{orig} -> {mid} -> {orig} convert round-trip at "
                    f"{op.site}"))
        if to != mid:
            produced[dst] = mid
    return out


def lint_host_transfers(tr: Trace, spec: ProgramSpec) -> List[Finding]:
    """Flag every host sync the program dispatched (the one that ended a
    meta trace last)."""
    if spec.allow_syncs:
        return []
    return [Finding("host-transfer", spec.name,
                    f"{s.kind} (`{s.op}`) at {s.site}"
                    + ("; the trace stops here" if s is tr.stopped else ""))
            for s in tr.syncs]


def lint_donation(spec: ProgramSpec,
                  tr: Optional[Trace] = None) -> List[Finding]:
    """Round-carried state must be donated, by declaration and in fact:
    every tensor of a donated positional arg comes back updated in place
    (some output shares its storage)."""
    out = [Finding("undonated-carry", spec.name,
                   f"round-carried arg {i} is not in donate={spec.donate}: "
                   f"the old buffer stays live an extra round "
                   f"(memory doubles at C >> 1000)")
           for i in spec.carry if i not in spec.donate]
    if tr is not None and tr.stopped is None:
        kept = set(tr.outputs)
        for i in spec.donate:
            ids = tr.arg_storages[i] if i < len(tr.arg_storages) else []
            moved = [s for s in ids if s not in kept]
            if moved:
                out.append(Finding(
                    "undonated-carry", spec.name,
                    f"declares donate={spec.donate} but {len(moved)} of the "
                    f"{len(ids)} tensors of arg {i} come back out of place "
                    f"(no output shares their storage)"))
    return out


def dead_ops(tr: Trace) -> List:
    """Ops whose outputs never (transitively) reach a program output or an
    op that writes a tensor. Ops that write one, and views, are never
    reported."""
    live: Set[int] = set(tr.outputs)
    dead = []
    for op in reversed(tr.ops):
        if op.effect or any(s in live for s, _ in op.outs):
            live.update(s for s, _ in op.ins)
        elif op.outs and not op.view:
            dead.append(op)
    return dead[::-1]


def lint_dead_code(tr: Trace, spec: ProgramSpec) -> List[Finding]:
    if tr.stopped is not None:        # the trace ends early: no verdict
        return []
    dead = dead_ops(tr)
    if not dead:
        return []
    names = sorted({op.name for op in dead})
    return [Finding(
        "dead-code", spec.name,
        f"{len(dead)} op(s) never reach an output "
        f"(ops: {', '.join(names[:6])}; first at {dead[0].site})")]


def lint_peak_bytes(tr: Trace, spec: ProgramSpec) -> List[Finding]:
    if tr.peak_bytes > spec.budget_bytes:
        return [Finding(
            "peak-bytes", spec.name,
            f"estimated peak intermediates {tr.peak_bytes / 1e6:.1f} MB "
            f"exceed the declared budget {spec.budget_bytes / 1e6:.1f} MB")]
    return []


# ---------------------------------------------------------------------------
# all passes
# ---------------------------------------------------------------------------


def run_jaxpr_lints(tr: Trace, spec: ProgramSpec
                    ) -> Tuple[List[Finding], Dict[str, int]]:
    """All passes over one traced program -> (findings, stats)."""
    findings: List[Finding] = []
    findings += lint_dtypes(tr, spec)
    findings += lint_convert_churn(tr, spec)
    findings += lint_host_transfers(tr, spec)
    findings += lint_donation(spec, tr)
    findings += lint_dead_code(tr, spec)
    findings += lint_peak_bytes(tr, spec)
    return findings, {"peak_bytes": tr.peak_bytes, "ops": len(tr.ops)}
