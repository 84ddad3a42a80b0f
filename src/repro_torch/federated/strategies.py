"""Federated(-lifelong) baselines (paper Table II).

The port of ``repro/federated/strategies.py``:

  * FedAvg  [Konečný+ 16]: upload theta, dispatch the uniform mean; every
    engine (the sharded one's mean is one all-reduce over the ranks). A
    client that takes the mean starts a fresh optimizer.
  * FedProx [Li+ 20]: FedAvg + the proximal term mu/2 ||theta - theta_g||^2
    towards the last dispatched mean; both engines.
  * FedCurv [Shoham+ 19]: FedAvg + each client's diagonal Fisher on the
    wire: clients regularise towards the *other* clients' important
    parameters. Its upload is three heads (theta, F, F theta), which is
    why its bytes explode in Table II. Host engine only.
  * FedWeIT [Yoon+ 21]: theta = B ⊙ sigmoid(m) + A + sum_j attn_j A_j with
    an l1-sparse A; each client uploads its top-30% A, the server relays
    every client's to every client. Host engine only.

Every regularizer returns the (C,) per-client penalties of a stack of
clients (``Strategy.regularizer``), so each client's gradient is clipped on
its own. The Fisher is taken per chunk of 8 prototypes through
``base.chunk_grads``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import (device_of, tree_bytes,
                                       tree_flatten_stacked, tree_leaves,
                                       tree_map, tree_slice, tree_stack,
                                       tree_unflatten_stacked)
from repro_torch.core.aggregation import fedavg_aggregate
from repro_torch.core.tying import _abs
from repro_torch.federated.base import (ClientState, Strategy, as_one,
                                        client_sum, fisher_diag, tree_copy)


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

    def server_round_stacked(self, rnd, upload, valid=None):
        """The mean over the C rows, broadcast back to every row (the
        host's uniform dispatch). On the sharded engine (``valid``: this
        rank's rows' validity) the mean is over the real clients of every
        rank: each rank's masked row sum of the flattened heads and its
        real count go through one all-reduce over "data"; every row,
        padding included, takes the mean."""
        theta = upload["theta"]
        with torch.no_grad():
            if valid is None:
                return {"theta": tree_map(
                    lambda l: (torch.sum(l, 0) / l.shape[0]).expand_as(
                        l).clone(), theta)}
            flat, meta = tree_flatten_stacked(theta)
            part = torch.cat([torch.sum(flat * valid[:, None], 0),
                              torch.sum(valid)[None]])
            total = self.mesh.all_sum(part)
            mean = total[:-1] / torch.clamp(total[-1], min=1.0)
            return {"theta": tree_unflatten_stacked(
                mean.expand_as(flat).contiguous(), meta)}

    def apply_dispatch_stacked(self, stacked, dispatch):
        stacked.trainable = dispatch["theta"]
        # a fresh optimizer on the new global params (host: opt_state=None)
        stacked.opt_state = self.opt.init(stacked.trainable)
        return stacked


class FedProx(FedAvg):
    name = "fedprox"

    def __init__(self, cfg, *, mu=0.01, **kw):
        super().__init__(cfg, **kw)
        self.mu = mu

    def init_client(self, theta0):
        st = super().init_client(theta0)
        st.extras["reg_global"] = tree_copy(st.theta)
        return st

    def regularizer(self, trainable, extras):
        pen = sum(client_sum(torch.square(t - g)) for t, g in zip(
            tree_leaves(trainable), tree_leaves(extras["reg_global"])))
        return 0.5 * self.mu * pen

    def apply_dispatch(self, state, dispatch):
        state = super().apply_dispatch(state, dispatch)
        state.extras["reg_global"] = dispatch["theta"]
        return state

    def apply_dispatch_stacked(self, stacked, dispatch):
        stacked = super().apply_dispatch_stacked(stacked, dispatch)
        # the proximal anchor follows the new global params (host parity),
        # a copy of them, not an alias
        stacked.extras["reg_global"] = tree_copy(stacked.trainable)
        return stacked


class FedCurv(FedAvg):
    name = "fedcurv"
    # the Fisher of each upload is a per-client chunked gradient over host
    # prototypes, which the stacked engine's uniform batched step does not
    # express (the reference's rule)
    supports_stacked = False

    def __init__(self, cfg, *, lam=0.01, **kw):
        super().__init__(cfg, **kw)
        self.lam = lam

    def init_client(self, theta0):
        st = super().init_client(theta0)
        st.extras["reg_fisher_sum"] = tree_map(torch.zeros_like, st.theta)
        st.extras["reg_fisher_theta_sum"] = tree_map(torch.zeros_like,
                                                     st.theta)
        return st

    def regularizer(self, trainable, extras):
        # sum_j F_j (t - t_j)^2 = t^2 sum F - 2 t sum(F t) + const
        pen = sum(
            client_sum(fs * torch.square(t)) - 2.0 * client_sum(ft * t)
            for fs, ft, t in zip(tree_leaves(extras["reg_fisher_sum"]),
                                 tree_leaves(extras["reg_fisher_theta_sum"]),
                                 tree_leaves(trainable)))
        return 0.5 * self.lam * pen

    def local_train(self, client, state, protos, labels, rnd, **_):
        state, _ = self._run_epochs(state, protos, labels)
        n = min(len(protos), 64)
        fisher = fisher_diag(state.theta, protos[:n], labels[:n])
        ftheta = tree_map(lambda f, t: f * t, fisher, state.theta)
        # theta + fisher + fisher * theta: three times FedAvg's upload
        return state, {"theta": state.theta, "fisher": fisher,
                       "ftheta": ftheta}

    def server_round(self, rnd, uploads):
        mean = fedavg_aggregate([u["theta"] for u in uploads.values()])
        out = {}
        for c in uploads:
            others = [u for cc, u in uploads.items() if cc != c]
            fsum = tree_map(lambda *xs: sum(xs),
                            *[o["fisher"] for o in others])
            ftsum = tree_map(lambda *xs: sum(xs),
                             *[o["ftheta"] for o in others])
            out[c] = {"theta": mean, "fisher_sum": fsum, "ftheta_sum": ftsum}
        return out

    def apply_dispatch(self, state, dispatch):
        state.theta = dispatch["theta"]
        state.opt_state = None
        state.extras["reg_fisher_sum"] = dispatch["fisher_sum"]
        state.extras["reg_fisher_theta_sum"] = dispatch["ftheta_sum"]
        return state

    def storage_bytes(self, state):
        return (tree_bytes(state.theta)
                + tree_bytes(state.extras["reg_fisher_sum"])
                + tree_bytes(state.extras["reg_fisher_theta_sum"]))


class FedWeIT(Strategy):
    """theta_c = B ⊙ sigmoid(m_c) + A_c + sum_j attn_cj A_j, l1-sparse A.

    Exchanged: the client's sparsified A and its mask up; every client's
    sparse A down, to every client (its own included)."""

    name = "fedweit"
    uses_server = True

    def __init__(self, cfg, *, l1=1e-4, l2=1e-6, n_clients=5, **kw):
        super().__init__(cfg, **kw)
        self.l1 = l1
        self.l2 = l2
        self.n_clients = n_clients

    def init_client(self, theta0):
        """The client's initial head is its base (the reference draws the
        base from the client's own key, as the initial head is drawn)."""
        base = theta0
        trainable = {"mask": tree_map(torch.ones_like, base),
                     "A": tree_map(torch.zeros_like, base),
                     "attn": torch.zeros((self.n_clients,),
                                         device=device_of(base))}
        st = ClientState(theta=trainable)
        st.extras["reg_base"] = base
        st.extras["reg_neighbors"] = tree_map(
            lambda x: x.new_zeros((self.n_clients,) + tuple(x.shape)), base)
        return st

    def make_theta(self, trainable, extras):
        """The stacked heads: attn (C, n), neighbours' leaves (C, n, ...)."""
        attn = torch.softmax(trainable["attn"], -1)
        return tree_map(
            lambda b, m, a, nb: b * torch.sigmoid(m) + a
            + torch.einsum("sc,sc...->s...", attn, nb),
            extras["reg_base"], trainable["mask"], trainable["A"],
            extras["reg_neighbors"])

    def regularizer(self, trainable, extras):
        # |a| with slope +1 at 0, as JAX's: A starts at exactly 0
        A = tree_leaves(trainable["A"])
        l1 = sum(client_sum(_abs(a)) for a in A)
        l2 = sum(client_sum(torch.square(a)) for a in A)
        return self.l1 * l1 + self.l2 * l2

    def _sparsify(self, A, keep_frac=0.3):
        """Keep every entry whose magnitude reaches the k-th largest, k =
        max(1, int(keep_frac * size)) per leaf (ties keep more than k)."""
        def sp(a):
            flat = torch.abs(a).reshape(-1)
            k = max(1, int(keep_frac * flat.numel()))
            thr = torch.sort(flat)[0][-k]
            return torch.where(torch.abs(a) >= thr, a, torch.zeros_like(a))
        with torch.no_grad():
            return tree_map(sp, A)

    def sparse_bytes(self, A) -> int:
        """fp32 values + int32 indices of the entries actually kept: the
        real nonzeros of the sparsified tree (equal to the measured bytes
        of a lossless sparse encoding)."""
        kept = sum(int(torch.count_nonzero(a)) for a in tree_leaves(A))
        return kept * (4 + 4)

    def local_train(self, client, state, protos, labels, rnd, **_):
        state, _ = self._run_epochs(state, protos, labels)
        A_sparse = self._sparsify(state.theta["A"])
        # nnz counted once here and carried beside the tree, so the
        # accounting never recounts a neighbour's copy per dispatch
        return state, {"A": A_sparse, "base_grad": state.theta["mask"],
                       "A_nnz": self.sparse_bytes(A_sparse) // 8}

    def server_round(self, rnd, uploads):
        # the base stays fixed; every client's sparse A goes to every client
        allA = {c: u["A"] for c, u in uploads.items()}
        nnz = {c: int(u["A_nnz"]) for c, u in uploads.items()}
        return {c: {"neighbors": allA, "neighbors_nnz": nnz}
                for c in uploads}

    def apply_dispatch(self, state, dispatch):
        neigh = dispatch["neighbors"]
        state.extras["reg_neighbors"] = tree_stack(
            [neigh[c] for c in sorted(neigh)])
        return state

    def _eval_theta(self, state):
        with torch.no_grad():
            return tree_slice(self.make_theta(as_one(state.theta),
                                              self._loss_extras(state)), 0)

    def storage_bytes(self, state):
        return (tree_bytes(state.theta) + tree_bytes(state.extras["reg_base"])
                + tree_bytes(state.extras["reg_neighbors"]))

    # the accounting counters are control metadata, not payload: they ship
    # verbatim, off the lossy codec (a large integer in a quantization
    # chunk of A entries would inflate that chunk's scale ~50x)
    def split_upload_for_wire(self, upload):
        return ({k: v for k, v in upload.items() if k != "A_nnz"},
                {"A_nnz": np.int64(upload["A_nnz"])})

    def join_upload_from_wire(self, decoded, verbatim):
        return {**decoded, **verbatim}

    def split_dispatch_for_wire(self, dispatch):
        return ({"neighbors": dispatch["neighbors"]},
                {"neighbors_nnz": {c: np.int64(n) for c, n in
                                   dispatch["neighbors_nnz"].items()}})

    def join_dispatch_from_wire(self, decoded, verbatim):
        return {**decoded, **verbatim}

    def upload_bytes(self, upload) -> int:
        nnz = upload.get("A_nnz")
        sparse = (int(nnz) * 8 if nnz is not None
                  else self.sparse_bytes(upload["A"]))
        return sparse + tree_bytes(upload["base_grad"])

    def dispatch_bytes(self, dispatch) -> int:
        nnz = dispatch.get("neighbors_nnz")
        if nnz is not None:
            return 8 * sum(int(n) for n in nnz.values())
        return sum(self.sparse_bytes(a)
                   for a in dispatch["neighbors"].values())
