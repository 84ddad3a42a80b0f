"""Lifelong-learning baselines (paper Table II, local-only methods): STL.

The port of ``STL`` in ``repro/lifelong/strategies.py``: plain local
training, nothing exchanged, on both engines. EWC, MAS and iCaRL come with
the strategy-zoo slice (ROADMAP, Queue 1).
"""
from __future__ import annotations

from repro_torch.federated.base import Strategy


class STL(Strategy):
    name = "stl"
    # pure local minibatch training: batches cleanly over clients
    supports_stacked = True
