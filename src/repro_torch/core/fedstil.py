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

On the sharded engine (``run_simulation(engine="sharded")``) each rank
holds a block of the Cp padded client rows. The server round all-gathers
the task features and validity of every row, keeps the relevance ring
replicated (Eq. 4 contracts every row against every history, and the ring
is only Cp x k x D), so W and Wn are the same on every rank, and forms
Eq. 5 -> 6 as ``sharded_fused_aggregate``: one launch of the fused
aggregate's column-block form (``ops.fused_relevance_aggregate(w,
thetas, lo, hi)``: Wn, and the rank's partial product of its own column
block of Wn and its rows of Theta), then one reduce-scatter over "data".
Each rank casts its flattened rows to ``wire_dtype`` (bf16 by default,
``common/precision.py``) and upcasts them to fp32 for its partial product:
the cast keeps the reference's precision rule, and saves no bytes here,
since no bf16 tensor crosses ranks (the one transfer of Eq. 6 is the fp32
(Cp, P) partial of the reduce-scatter).

Ablation switches (Table III): ``st_integration``, ``rehearsal``,
``tying``; the similarity switch (Table VI): ``metric``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common.precision import to_bf16, to_f32
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


def sharded_fused_aggregate(w, thetas, mesh):
    """Eq. 5 -> 6 over the engine mesh (the layouts of
    ``sharding.specs.stacked_aggregate_specs``): ``w`` the replicated raw
    relevance (C, C), ``thetas`` this rank's (C / d, P / m) block of the
    stacked parameters (client rows over "data", columns over "model").

    One launch of the fused aggregate's column-block form
    (``ops.fused_relevance_aggregate(w, thetas, *block_r)``) gives Wn
    (the diagonal masked, rows normalized, zero rows kept zero; the same
    on every rank, and on the card the fused kernel's bit for bit) and
    rank r's (C, P / m) fp32 partial product Wn[:, block_r] @ thetas of
    its own column block of Wn against its rows; one reduce-scatter over
    "data" sums the partials and leaves rank r with its own rows of B (on
    one rank, the fused kernel's B bit for bit). Returns (B block (C / d,
    P / m) fp32, Wn (C, C))."""
    partial, wn = ops.fused_relevance_aggregate(
        w, thetas.contiguous(), *mesh.block(w.shape[0]))
    return mesh.reduce_scatter_rows(partial), wn


class _StackedServer:
    """Where the stacked engine's server round differs from the sharded
    one's: every row is here and real, the flatten stays fp32, and Eq. 6
    is the one fused launch."""

    @staticmethod
    def gather(feats):
        return feats, None

    @staticmethod
    def wire(flat):
        return flat

    @staticmethod
    def aggregate(w, flat):
        """(B (C, P), Wn (C, C), this rank's rows of Wn)."""
        B, Wn = ops.fused_relevance_aggregate(w, flat)
        return B, Wn, Wn


class _ShardedServer:
    """The same steps on the sharded engine, for this rank's rows of
    ``mesh`` with validity ``valid`` (1.0 real, 0.0 padding)."""

    def __init__(self, mesh, valid, wire_dtype):
        self.mesh, self.valid, self.wire_dtype = mesh, valid, wire_dtype

    def gather(self, feats):
        """Every row's task feature and validity: ((Cp, D), (Cp,))."""
        D = feats.shape[1]
        both = self.mesh.all_gather_rows(
            torch.cat([feats, self.valid[:, None].to(feats.dtype)], 1))
        return both[:, :D], both[:, D]

    def wire(self, flat):
        return to_bf16(flat) if self.wire_dtype == "bfloat16" else flat

    def aggregate(self, w, flat):
        B, Wn = sharded_fused_aggregate(w, to_f32(flat), self.mesh)
        lo, hi = self.mesh.block(Wn.shape[0])
        return B, Wn, Wn[lo:hi]


class FedSTIL(Strategy):
    name = "fedstil"
    uses_server = True
    supports_stacked = True

    def __init__(self, cfg, *, n_clients=5, metric="kl", forgetting_ratio=0.5,
                 history_len=6, memory_size=2000, per_identity=8,
                 lam_tie=1e-4, st_integration=True, rehearsal=True,
                 tying=True, server_backend=None, wire_dtype="bfloat16",
                 **kw):
        super().__init__(cfg, **kw)
        if wire_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"wire_dtype {wire_dtype!r}: 'bfloat16' or "
                             "'float32'")
        # the sharded engine casts each rank's flattened rows to
        # wire_dtype and upcasts them to fp32 for the aggregate: bf16 (the
        # default) keeps the reference's precision rule but saves no bytes
        # here, as no bf16 tensor crosses ranks (module docstring);
        # "float32" turns the cast off. The host and stacked engines
        # ignore it, as the reference's do.
        self.wire_dtype = wire_dtype
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
        C = len(protos_list)
        if self.use_rehearsal:
            # every rank keeps all C memories (its rng draws must stay the
            # reference's), so the head outputs of every client's
            # prototypes are gathered from the ranks that hold them
            protos = self.place_rows(torch.from_numpy(np.stack(protos_list)),
                                     dev)
            with torch.no_grad():
                outputs = EM.adaptive_forward(theta, protos)[0]
                if self.mesh is not None:
                    outputs = self.mesh.all_gather_rows(outputs)
            outputs = outputs[:C].cpu().numpy()
            for c, mem in enumerate(stacked.host["memory"]):
                mem.add_task(protos_list[c], labels_list[c], outputs[c],
                             task_id=rnd)
        # upload: the heads + the task feature (Eq. 3); padding rows get a
        # zero feature, which their validity keeps out of the ring
        feats = torch.from_numpy(np.stack([np.asarray(p, np.float32).mean(0)
                                           for p in protos_list]))
        if self.mesh is not None:
            feats = torch.cat([feats, feats.new_zeros(
                (self.padded_clients - C, feats.shape[1]))])
        return stacked, {"theta": theta,
                         "task_feature": self.place_rows(feats, dev)}

    # ---- stacked engine: server round ----------------------------------------
    def server_round_stacked(self, rnd, upload, valid=None):
        """Eq. 4/5 -> Eq. 6 over the device-resident ring. The only host
        readback is the (C, C) ``last_W``. Returns {"B": stacked bases,
        "nz": (C,) bool rows with relevant neighbours}.

        On the sharded engine (``valid``: this rank's rows' validity) the
        upload holds this rank's rows: the task features and validity of
        every row are gathered, the replicated (Cp, k, D) ring takes a
        push of the valid rows only (padding never acquires history, so
        its W rows and columns stay zero and it keeps its base), the
        flatten is cast to ``wire_dtype`` and the aggregate is
        ``sharded_fused_aggregate``; "B" and "nz" are this rank's rows and
        ``last_W`` the (Cp, Cp) Wn. Traced, the stage spans take their
        device time from their stamps: none waits on the device."""
        if not self.st_integration:
            return None
        io = (_StackedServer if valid is None
              else _ShardedServer(self.mesh, valid, self.wire_dtype))
        with torch.no_grad():
            with obs.span("server.relevance", cat="stage", round=rnd):
                feats, mask = io.gather(upload["task_feature"])  # (C, D)
                if self._ring is None:
                    C, D = feats.shape
                    self._ring = DeviceRingHistory(C, self.history_len, D,
                                                   feats.device)
                ring = self._ring
                ring.push_all(feats, mask)
                W_raw = ring.raw_relevance(
                    forgetting_ratio=self.forgetting_ratio,
                    metric=self.metric)
            with obs.span("server.flatten", cat="stage", round=rnd):
                flat, meta = flatten_stacked(upload["theta"])  # (C, P)
                flat = io.wire(flat)
            with obs.span("server.aggregate", cat="stage", round=rnd):
                B_flat, Wn, Wn_mine = io.aggregate(W_raw, flat)
            # per-client round observables (staleness, ring fill, W row
            # mass / density): computed and read back only under a tracer
            if obs.is_active():
                obs.metric("server.relevance",
                           relevance_metrics(W_raw, ring.valid, ring.stale),
                           round=rnd)
            self.last_W = Wn.cpu().numpy()
            # all-zero rows (no relevant neighbours yet) keep their old base
            nz = torch.sum(Wn_mine, 1) > 0
            with obs.span("server.unflatten", cat="stage", round=rnd):
                B = unflatten_stacked(B_flat, meta)
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
