"""Static analysis of the port's hot programs, on meta tensors (the port
of ``repro/analysis``).

Three layers (see ``analysis/README.md``):

  * ``registry``    ``@register_program`` decorator + runtime manifest:
    every hot entry point is traceable from one place, on meta tensors (no
    data, no device), under a recording dispatch mode built on the
    production lowering's ``OpCounter``.
  * ``lints``       passes over each program's recorded ops: dtype
    widening beyond the declared wire dtypes, convert churn, host syncs,
    round-carried state not updated in place, dead ops, and the counter's
    peak live bytes against each program's declared budget.
  * ``conventions`` AST-level conventions of the port: every CUDA kernel
    paired with a plain version + ops dispatcher + parity test + card
    check, every registered fast path naming its host oracle inside the
    port, no unused imports, no unreached seed modules without an
    allowlist entry.

CLI gate: ``python -m repro_torch.analysis.lint [--program NAME] [--json]``,
with ``baseline.json`` suppressing known findings so new ones fail loudly
while old ones burn down.
"""
from repro_torch.analysis.registry import (ProgramSpec, coverage, get_program,
                                           iter_programs, load_all,
                                           register_program, register_runtime)

__all__ = [
    "ProgramSpec", "coverage", "get_program", "iter_programs", "load_all",
    "register_program", "register_runtime",
]
