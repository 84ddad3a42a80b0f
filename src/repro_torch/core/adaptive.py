"""FedSTIL adaptive-layer parameterization (paper Eq. 2):

    theta_c = B_c ⊙ alpha_c + A_c

``B_c`` carries the spatial-temporal knowledge the server dispatches,
``alpha_c`` is a learnable attention over it and ``A_c`` the locally learnt
residual; (alpha_c, A_c) train locally. The port of ``AdaptiveState``,
``combine`` and ``init_adaptive`` in ``repro/core/adaptive.py``, leaf-wise
over the port's flat head dicts, so a leading client axis passes straight
through. ``combine`` goes through ``kernels.ops.adaptive_combine_tree``
(for CUDA tensors one kernel launch per dtype group over every leaf,
differentiable), the form the reference names as its hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.kernels import ops

Theta = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdaptiveState:
    """Per-client decomposed adaptive parameters."""

    B: Theta          # base (server-provided spatial-temporal knowledge)
    alpha: Theta      # attention over B
    A: Theta          # local residual

    def theta(self) -> Theta:
        return combine(self.B, self.alpha, self.A)

    def trainable(self) -> Dict[str, Theta]:
        return {"alpha": self.alpha, "A": self.A}

    def with_trainable(self, t) -> "AdaptiveState":
        return AdaptiveState(B=self.B, alpha=t["alpha"], A=t["A"])

    def with_base(self, B) -> "AdaptiveState":
        return AdaptiveState(B=B, alpha=self.alpha, A=self.A)


def combine(B: Theta, alpha: Theta, A: Theta) -> Theta:
    """theta = B ⊙ alpha + A, leaf-wise (paper Eq. 2)."""
    return ops.adaptive_combine_tree(B, alpha, A)


def init_adaptive(theta0: Theta) -> AdaptiveState:
    """Start with theta == theta0: B = theta0, alpha = 1, A = 0."""
    return AdaptiveState(B=theta0, alpha=tree_map(torch.ones_like, theta0),
                         A=tree_map(torch.zeros_like, theta0))


# ---------------------------------------------------------------------------
# model-level split: which sub-tree of a full LM is "adaptive"
# ---------------------------------------------------------------------------

_ADAPTIVE_KEYS = ("adaptive_layers", "shared_attn", "head", "final_norm")


def split_params(cfg, params):
    """(frozen extraction layers, adaptive layers) of an LM's params."""
    adaptive = {k: params[k] for k in _ADAPTIVE_KEYS if k in params}
    frozen = {k: v for k, v in params.items() if k not in adaptive}
    return frozen, adaptive


def merge_params(frozen, adaptive):
    out = dict(frozen)
    out.update(adaptive)
    return out
