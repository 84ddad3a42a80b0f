"""Communication-cost accounting: measured wire bytes + analytic formulas.

A copy of ``repro/comm/accounting.py``; payload sizes come from the
port's ``common.pytree.tree_bytes``.

Two parallel per-round ledgers per direction (S2C / C2S, paper Table II):

  * **wire** (``c2s`` / ``s2c``) — the bytes that actually move. When a
    strategy carries wire codecs (``Strategy(codec="delta+topk")``), these
    are the MEASURED sizes of the encoded ``WirePayload`` buffers (plus any
    verbatim control tensors); without codecs they equal the formulas, so
    pre-codec callers see identical totals.
  * **formula** (``c2s_formula`` / ``s2c_formula``) — the analytic payload
    formulas (``tree_bytes``, FedWeIT's ``nnz * (4 + 4)``), always
    recorded. They are the cross-check oracle for the measured path: the
    codec tests assert formula ~= measured for the stages the formulas
    model, and ``round_breakdown()`` exposes both so Fig. 8 reproduction
    reports measured traffic next to what the paper's accounting assumes.

``measured`` stays False until the first measured log, so ``total`` keeps
its historical meaning (formula bytes) for codec-less runs.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.common.pytree import tree_bytes


@dataclasses.dataclass
class CommLog:
    def __post_init__(self):
        self.c2s: Dict[int, int] = defaultdict(int)   # wire bytes per round
        self.s2c: Dict[int, int] = defaultdict(int)
        self.c2s_formula: Dict[int, int] = defaultdict(int)
        self.s2c_formula: Dict[int, int] = defaultdict(int)
        self.measured = False                         # any measured log yet?

    @staticmethod
    def _size(payload) -> int:
        return payload if isinstance(payload, int) else tree_bytes(payload)

    def _log(self, wire, formula, rnd, payload, n, measured, n_formula):
        f = self._size(payload)
        formula[rnd] += (n if n_formula is None else n_formula) * f
        if measured is None:
            wire[rnd] += n * f
        else:
            wire[rnd] += n * int(measured)
            self.measured = True

    def log_c2s(self, rnd: int, payload, measured: Optional[int] = None):
        """``payload``: pytree or formula byte count; ``measured``: the
        encoded WirePayload's byte count (None = no codec, wire=formula)."""
        self._log(self.c2s, self.c2s_formula, rnd, payload, 1, measured, None)

    def log_s2c(self, rnd: int, payload, measured: Optional[int] = None):
        self._log(self.s2c, self.s2c_formula, rnd, payload, 1, measured, None)

    # batched logging: the stacked engine moves C identical-size payloads
    # per round — one accounting call instead of a per-client Python loop
    # (``payload``/``measured`` are per-client sizes, counted n times;
    # ``n_formula`` lets the formula oracle keep its own multiplicity when
    # the wire model ships a different number of copies, e.g. the stacked
    # broadcast dispatch stream vs the host engine's per-client dispatches)
    def log_c2s_many(self, rnd: int, payload, n: int,
                     measured: Optional[int] = None,
                     n_formula: Optional[int] = None):
        self._log(self.c2s, self.c2s_formula, rnd, payload, n, measured,
                  n_formula)

    def log_s2c_many(self, rnd: int, payload, n: int,
                     measured: Optional[int] = None,
                     n_formula: Optional[int] = None):
        self._log(self.s2c, self.s2c_formula, rnd, payload, n, measured,
                  n_formula)

    # ---- totals (wire = measured when codecs are active) ---------------------
    @property
    def total_c2s(self) -> int:
        return sum(self.c2s.values())

    @property
    def total_s2c(self) -> int:
        return sum(self.s2c.values())

    @property
    def total(self) -> int:
        return self.total_c2s + self.total_s2c

    @property
    def total_c2s_formula(self) -> int:
        return sum(self.c2s_formula.values())

    @property
    def total_s2c_formula(self) -> int:
        return sum(self.s2c_formula.values())

    @property
    def total_formula(self) -> int:
        return self.total_c2s_formula + self.total_s2c_formula

    def round_breakdown(self) -> List[Dict[str, int]]:
        """Per-round measured-vs-formula rows, sorted by round."""
        rounds = sorted(set(self.c2s) | set(self.s2c)
                        | set(self.c2s_formula) | set(self.s2c_formula))
        return [{"round": r,
                 "c2s_wire": self.c2s.get(r, 0),
                 "s2c_wire": self.s2c.get(r, 0),
                 "c2s_formula": self.c2s_formula.get(r, 0),
                 "s2c_formula": self.s2c_formula.get(r, 0)}
                for r in rounds]


def fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"
