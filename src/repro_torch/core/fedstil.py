"""FedSTIL, the paper's method (Algorithm 1), on both engines.

The port of ``repro/core/fedstil.py``. Per round, for every client (the
stacked engine: all C clients at once):

  1. prototypes of the current task arrive (extraction layers frozen);
  2. each client trains (alpha_c, A_c) of theta_c = B_c ⊙ alpha_c + A_c
     (Eq. 2) on current prototypes plus rehearsal samples, with parameter
     tying, then stores nearest-mean exemplar prototypes;
  3. the server receives theta and the task feature (mean prototype,
     Eq. 3), pushes the features into its (C, k, D) ring, computes KL task
     similarity (Eq. 4, ``ops.kl_similarity``) and decayed relevance W
     (Eq. 5), and in one fused step masks the diagonal, row-normalizes W
     and forms the bases B = Wn Θ over the flattened (C, P) parameters
     (Eq. 6, ``ops.fused_relevance_aggregate``);
  4. clients whose row of Wn has mass take their new base; the others keep
     theirs.

The host engine's server round keeps its histories in a
``RelevanceTracker`` (host lists mirrored into a device ring), normalizes
the participating block of W and forms the bases of the rows with mass as
one (|nz|, C) x (C, P) product (``core.aggregation.personalized_aggregate``,
``ops.relevance_aggregate``). ``server_backend="loop"`` runs the tracker's
per-pair loop and the per-leaf einsum aggregate instead, the reference's
oracle; the stacked server ignores it, as the reference's does.

Ablation switches (Table III): ``st_integration``, ``rehearsal``,
``tying``; the similarity switch (Table VI): ``metric``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common.pytree import (device_of, flatten_stacked,
                                       tree_bytes, unflatten_stacked)
from repro_torch.core import edge_model as EM
from repro_torch.core.adaptive import combine, init_adaptive
from repro_torch.core.aggregation import personalized_aggregate
from repro_torch.core.rehearsal import PrototypeMemory
from repro_torch.core.relevance import (DeviceRingHistory, RelevanceTracker,
                                        normalize_rows)
from repro_torch.core.tying import tying_loss
from repro_torch.federated.base import ClientState, Strategy, forward_one
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import relevance_metrics


class FedSTIL(Strategy):
    name = "fedstil"
    uses_server = True
    supports_stacked = True

    def __init__(self, cfg, *, n_clients=5, metric="kl", forgetting_ratio=0.5,
                 history_len=6, memory_size=2000, per_identity=8,
                 lam_tie=1e-4, st_integration=True, rehearsal=True,
                 tying=True, server_backend=None, **kw):
        super().__init__(cfg, **kw)
        self.n_clients = n_clients
        self.metric = metric
        self.forgetting_ratio = forgetting_ratio
        self.history_len = history_len
        self.lam_tie = lam_tie
        self.st_integration = st_integration
        self.use_rehearsal = rehearsal
        self.use_tying = tying
        self.memory_size = memory_size
        self.per_identity = per_identity
        # server_backend: None = kernels by tensor device, "loop" = the
        # host server's per-pair relevance and per-leaf aggregate reference
        self.server_backend = server_backend
        self.tracker = RelevanceTracker(
            n_clients, history_len=history_len,
            forgetting_ratio=forgetting_ratio, metric=metric,
            backend=server_backend)
        # the stacked engine's own ring (the host tracker stays untouched)
        self._ring: Optional[DeviceRingHistory] = None
        self.last_W: Optional[np.ndarray] = None

    # ---- decomposition -------------------------------------------------------
    def init_client(self, theta0) -> ClientState:
        """One client from its initial head (flat dict, no client axis)."""
        ad = init_adaptive(theta0)
        return ClientState(theta=ad.trainable(), extras={
            "reg_B": ad.B, "reg_prev_theta": theta0,
            "memory": PrototypeMemory(capacity=self.memory_size,
                                      per_identity=self.per_identity)})

    def make_theta(self, trainable, extras):
        return combine(extras["reg_B"], trainable["alpha"], trainable["A"])

    def regularizer(self, trainable, extras):
        if not self.use_tying:
            return 0.0
        return tying_loss(self.make_theta(trainable, extras),
                          extras["reg_prev_theta"], lam_l1=self.lam_tie)

    def _eval_theta(self, state):
        return self.make_theta(state.theta, state.extras)

    def eval_theta_stacked(self, stacked):
        return combine(stacked.extras["reg_B"], stacked.trainable["alpha"],
                       stacked.trainable["A"])

    def storage_bytes(self, state: ClientState) -> int:
        mem: PrototypeMemory = state.extras["memory"]
        return (tree_bytes(state.theta) + tree_bytes(state.extras["reg_B"])
                + mem.size_bytes)

    # ---- host engine -----------------------------------------------------------
    def local_train(self, client, state, protos, labels, rnd, **_):
        rehearsal = None
        mem: PrototypeMemory = state.extras["memory"]
        if self.use_rehearsal and len(mem):
            rehearsal = mem.sample(self.rng, self.batch)
        state, _ = self._run_epochs(state, protos, labels, rehearsal)
        theta = self._eval_theta(state)
        state.extras["reg_prev_theta"] = theta
        # store exemplar prototypes (nearest-mean, Fig. 4)
        if self.use_rehearsal:
            mem.add_task(protos, labels, forward_one(theta, protos),
                         task_id=rnd)
        # upload: the head + the task feature (Eq. 3)
        task_feature = np.asarray(protos, np.float32).mean(0)
        return state, {"theta": theta, "task_feature": task_feature}

    def server_round(self, rnd, uploads):
        """Eq. 4/5 over the tracker, then Eq. 6 for the participating
        clients with relevant neighbours. Returns {client: {"B": base}},
        {} for a client without relevant neighbours yet."""
        if not self.st_integration or not uploads:
            return {}
        clients = sorted(uploads)
        self.tracker.device = device_of(uploads[clients[0]]["theta"])
        D = np.asarray(uploads[clients[0]]["task_feature"]).shape[-1]
        feats = np.zeros((self.n_clients, D), np.float32)
        mask = np.zeros((self.n_clients,), np.float32)
        for c in clients:
            feats[c] = uploads[c]["task_feature"]
            mask[c] = 1.0
        self.tracker.push_all(feats, mask)
        W = self.tracker.relevance()
        self.last_W = W
        # only rows with relevant neighbours are aggregated; under partial
        # participation the block of the clients that uploaded is
        # renormalized, so Eq. 6 stays a convex combination
        Wc = normalize_rows(W[np.ix_(clients, clients)])
        nz = np.flatnonzero(Wc.sum(1) > 0)
        out = {c: {} for c in clients}
        if nz.size:
            bases = personalized_aggregate(
                [uploads[c]["theta"] for c in clients], Wc[nz],
                backend=self.server_backend)
            for row, base in zip(nz, bases):
                out[clients[row]] = {"B": base}
        return out

    def apply_dispatch(self, state, dispatch):
        if "B" in dispatch:
            state.extras["reg_B"] = dispatch["B"]
        return state

    # ---- stacked engine: local round -----------------------------------------
    def _gather_rehearsal(self, stacked, c):
        if not self.use_rehearsal:
            return None
        mem: PrototypeMemory = stacked.host["memory"][c]
        if not len(mem):
            return None
        return mem.sample(self.rng, self.batch)

    def local_train_stacked(self, stacked, bx, by, protos_list, labels_list,
                            rnd):
        stacked, _ = super().local_train_stacked(stacked, bx, by,
                                                 protos_list, labels_list, rnd)
        theta = self.eval_theta_stacked(stacked)
        stacked.extras["reg_prev_theta"] = theta
        dev = bx.device
        if self.use_rehearsal:
            protos = torch.from_numpy(np.stack(protos_list)).to(dev)
            with torch.no_grad():
                outputs = EM.adaptive_forward(theta, protos)[0].cpu().numpy()
            for c, mem in enumerate(stacked.host["memory"]):
                mem.add_task(protos_list[c], labels_list[c], outputs[c],
                             task_id=rnd)
        # upload: the heads + the task feature (Eq. 3)
        feats = np.stack([np.asarray(p, np.float32).mean(0)
                          for p in protos_list])
        return stacked, {"theta": theta,
                         "task_feature": torch.from_numpy(feats).to(dev)}

    # ---- stacked engine: server round ----------------------------------------
    def server_round_stacked(self, rnd, upload):
        """Eq. 4/5 -> Eq. 6 over the device-resident ring. The only host
        readback is the (C, C) ``last_W``. Returns {"B": stacked bases,
        "nz": (C,) bool rows with relevant neighbours}."""
        if not self.st_integration:
            return None
        feats = upload["task_feature"]                       # (C, D)
        C, D = feats.shape
        with torch.no_grad():
            if self._ring is None:
                self._ring = DeviceRingHistory(C, self.history_len, D,
                                               feats.device)
            ring = self._ring
            with obs.span("server.relevance", cat="stage", round=rnd) as sp:
                ring.push_all(feats)
                W_raw = sp.sync(ring.raw_relevance(
                    forgetting_ratio=self.forgetting_ratio,
                    metric=self.metric))
            with obs.span("server.flatten", cat="stage", round=rnd) as sp:
                flat, meta = flatten_stacked(upload["theta"])  # (C, P)
                sp.sync(flat)
            with obs.span("server.aggregate", cat="stage", round=rnd) as sp:
                B_flat, Wn = sp.sync(ops.fused_relevance_aggregate(W_raw,
                                                                   flat))
            # per-client round observables (staleness, ring fill, W row
            # mass / density): computed and read back only under a tracer
            if obs.is_active():
                obs.metric("server.relevance",
                           relevance_metrics(W_raw, ring.valid, ring.stale),
                           round=rnd)
            self.last_W = Wn.cpu().numpy()
            # all-zero rows (no relevant neighbours yet) keep their old base
            nz = torch.sum(Wn, 1) > 0
            with obs.span("server.unflatten", cat="stage", round=rnd) as sp:
                B = sp.sync(unflatten_stacked(B_flat, meta))
        return {"B": B, "nz": nz}

    # ---- wire-codec payload split --------------------------------------------
    # Uploads are (theta, task feature): theta is the bulk payload the codec
    # compresses; the Eq. 3 task feature is the server's control plane for
    # relevance (Eq. 4/5) and ships verbatim. Dispatches are (B, nz): only B
    # is wire payload, the (C,) mask ships verbatim.

    def split_upload_for_wire(self, upload):
        return ({"theta": upload["theta"]},
                {"task_feature": upload["task_feature"]})

    def join_upload_from_wire(self, decoded, verbatim):
        return {"theta": decoded["theta"], **verbatim}

    def split_dispatch_for_wire(self, dispatch):
        verbatim = {k: v for k, v in dispatch.items() if k != "B"}
        return {"B": dispatch["B"]}, (verbatim or None)

    def join_dispatch_from_wire(self, decoded, verbatim):
        return {"B": decoded["B"], **(verbatim or {})}

    def apply_dispatch_stacked(self, stacked, dispatch):
        nz = dispatch["nz"]
        stacked.extras["reg_B"] = {
            k: torch.where(nz.reshape((-1,) + (1,) * (old.dim() - 1)),
                           dispatch["B"][k].to(old.dtype), old)
            for k, old in stacked.extras["reg_B"].items()}
        return stacked

    def stacked_dispatch_bytes(self, dispatch, n_clients: int) -> int:
        return tree_bytes(dispatch["B"]) // max(n_clients, 1)
