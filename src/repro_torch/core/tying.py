"""Parameter tying regularization (paper §IV-C, ablated in Table III), per
client of a stacked head:

    L_tie = lambda_tie * sum |theta - theta_prev|_1

The port of ``repro/core/tying.py``. ``|d|`` is written as
``where(d >= 0, d, -d)``: its derivative at 0 is +1, as JAX's ``abs``
gives it, where ``torch.abs`` gives 0. It matters from the first step on:
a client starts a round with theta == theta_prev exactly, so every entry
of the difference is 0 there.
"""
from __future__ import annotations

from typing import Dict

import torch


def _abs(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d >= 0, d, -d)


def tying_loss(theta: Dict[str, torch.Tensor],
               theta_prev: Dict[str, torch.Tensor],
               lam_l1: float = 1e-4) -> torch.Tensor:
    """Stacked heads (leaves (C, ...)) -> (C,) per-client penalties (the
    reference's ``lam_l2`` term, which no caller sets, is not ported)."""
    return lam_l1 * sum(torch.sum(_abs(theta[k] - theta_prev[k]).flatten(1), 1)
                        for k in sorted(theta))
