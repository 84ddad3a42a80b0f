"""Federated baselines (paper Table II): FedAvg.

The port of ``FedAvg`` in ``repro/federated/strategies.py``: clients upload
their heads and the server dispatches the uniform mean, on both engines;
a client that takes the mean starts a fresh optimizer. FedProx, FedCurv
and FedWeIT come with the strategy-zoo slice (ROADMAP, Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.core.aggregation import fedavg_aggregate
from repro_torch.federated.base import Strategy


class FedAvg(Strategy):
    name = "fedavg"
    uses_server = True
    supports_stacked = True

    # ---- host engine -----------------------------------------------------------
    def local_train(self, client, state, protos, labels, rnd, **_):
        state, _ = self._run_epochs(state, protos, labels)
        return state, {"theta": state.theta}

    def server_round(self, rnd, uploads):
        mean = fedavg_aggregate([u["theta"] for u in uploads.values()])
        return {c: {"theta": mean} for c in uploads}

    def apply_dispatch(self, state, dispatch):
        state.theta = dispatch["theta"]
        state.opt_state = None          # fresh optimizer on new global params
        return state

    # ---- stacked engine ----------------------------------------------------------
    def local_train_stacked(self, stacked, bx, by, protos_list, labels_list,
                            rnd):
        stacked, _ = super().local_train_stacked(stacked, bx, by,
                                                 protos_list, labels_list,
                                                 rnd)
        return stacked, {"theta": stacked.trainable}

    def server_round_stacked(self, rnd, upload):
        """The mean over the C rows, broadcast back to every row (the
        host's uniform dispatch)."""
        with torch.no_grad():
            return {"theta": tree_map(
                lambda l: (torch.sum(l, 0) / l.shape[0]).expand_as(l).clone(),
                upload["theta"])}

    def apply_dispatch_stacked(self, stacked, dispatch):
        stacked.trainable = dispatch["theta"]
        # a fresh optimizer on the new global params (host: opt_state=None)
        stacked.opt_state = self.opt.init(stacked.trainable)
        return stacked
