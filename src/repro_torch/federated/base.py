"""Shared machinery of the stacked federated engine.

The port of the stacked API of ``repro/federated/base.py``. All C clients'
trainable parameters, optimizer states and array extras live as one tree
of ``(C, ...)`` tensors (``StackedClientState``); per-client objects that
cannot be stacked (rehearsal memories) stay in per-client ``host`` lists.
A round is:

  * ``gather_round_batches``: every client's epoch minibatches drawn on the
    host from ``self.rng`` in the reference's exact order (client-major,
    then epoch; the rehearsal pool first, then each epoch's batch and
    rehearsal indices), so both packages train on identical batches;
  * ``local_train_stacked``: each epoch is one batched forward and backward
    over all clients (``torch.bmm`` where the reference vmaps; autograd of
    the sum of the clients' losses, which do not interact), per-client
    clipping and one stacked Adam step;
  * the strategy's server round and dispatch, each direction optionally
    through a wire codec (``codec=``): all C payload rows encoded and
    decoded at once by a ``comm.batched.BatchedCodec``;
  * ``eval_round_stacked``: every (client, task) retrieval evaluation in
    one pass (``stacked_eval_program`` of the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.comm.batched import BatchedCodec
from repro_torch.comm.codec import make_codec
from repro_torch.common.pytree import (tree_bytes, tree_flatten_stacked,
                                       tree_map, tree_unflatten_stacked)
from repro_torch.core import edge_model as EM
from repro_torch.evalreid.batched import _PAD_QID, batched_retrieval_metrics
from repro_torch.train.optimizer import adam, apply_updates, clip_by_global_norm


@dataclasses.dataclass
class ClientState:
    """One client's state before stacking (and its view after)."""

    theta: Any                        # the trainable tree (strategy-defined)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StackedClientState:
    """All C clients' states as one tree of (C, ...) tensors; ``host``
    keeps per-client objects as length-C lists."""

    n_clients: int
    trainable: Any
    opt_state: Any
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    host: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)


def _is_stackable(value) -> bool:
    return isinstance(value, (dict, torch.Tensor))


def stack_trees(trees: List[Any]):
    """Length-C list of trees of one structure -> one tree of (C, ...)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def eval_round_stacked(theta, qp, qids, task_mask, gp, gids, gmask, *,
                       ranks=(1, 3, 5), max_matches=None):
    """Every client x task retrieval evaluation of one round.

    theta: stacked eval-time head (leaves (C, ...)); qp (C, T, Q, D) query
    prototypes of all tasks, trained or not (``task_mask`` (C, T) 1.0 =
    trained; the others' query ids become -2 and never match); qids
    (C, T, Q); gp (C, G, D) gallery prototypes padded to a common G, gids
    (C, G), gmask (C, G) validity. Gallery features take BN statistics over
    each client's valid rows; each (c, t) query set is its own BN batch.
    Returns ``batched_retrieval_metrics``' dict of (C, T) tensors.
    """
    with torch.no_grad():
        f = EM.adaptive_pre_bn(theta, gp)
        mu, sd = EM.adaptive_bn_stats(f, gmask)
        gal_f = EM.adaptive_bn_apply(theta, f, mu, sd)
        qf = EM.adaptive_features_sets(theta, qp)
        qids_eff = torch.where(task_mask[:, :, None] > 0, qids,
                               torch.full((), _PAD_QID, device=qids.device))
        return batched_retrieval_metrics(qf, qids_eff, gal_f, gids,
                                         gmask=gmask, ranks=ranks,
                                         max_matches=max_matches)


def not_in_this_slice(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {where} (ROADMAP, Queue 1)")


class Strategy:
    """Base: plain local training (STL) on the stacked engine. A strategy
    with ``uses_server`` also defines ``server_round_stacked``,
    ``apply_dispatch_stacked`` and ``stacked_dispatch_bytes``."""

    name = "stl"
    uses_server = False
    supports_stacked = True

    def __init__(self, cfg: EM.EdgeModelConfig, *, lr=1e-3, weight_decay=1e-5,
                 epochs=5, batch=64, seed=0, codec=None, codec_opts=None):
        self.cfg = cfg
        self.lr = lr
        self.epochs = epochs
        self.batch = batch
        self.opt = adam(lr=lr, weight_decay=weight_decay)
        self.rng = np.random.default_rng(seed)
        # host wall ms of the last server round's stages (strategies with a
        # server fill it in)
        self.server_ms: Dict[str, float] = {}
        # wire codecs (comm.codec): when set, the simulation encodes every
        # upload and dispatch, logs the MEASURED buffer bytes (the formulas
        # stay as the cross-check), and the receiver trains on the decoded,
        # possibly lossy, payload. One codec per direction, so delta state
        # never crosses streams.
        opts = dict(codec_opts or {})
        self.upload_codec = make_codec(codec, **opts)
        self.dispatch_codec = make_codec(codec, **opts)
        self._wire_programs: Dict[Tuple[str, int], BatchedCodec] = {}

    # ---- loss ----------------------------------------------------------------
    def make_theta(self, trainable, extras):
        """Trainable tree -> the stacked head (identity here; FedSTIL:
        theta = B ⊙ alpha + A)."""
        return trainable

    def loss(self, trainable, protos, labels, extras) -> torch.Tensor:
        """(C,) per-client losses."""
        return EM.ce_loss(self.make_theta(trainable, extras), protos, labels)

    def regularizer(self, trainable, extras):
        """(C,) per-client penalties, or 0.0 for none."""
        return 0.0

    # ---- state ---------------------------------------------------------------
    def init_client(self, theta0) -> ClientState:
        return ClientState(theta=theta0)

    def stack_states(self, states: Dict[int, ClientState]) -> StackedClientState:
        """Stack C per-client states; array extras go to the device tree,
        everything else to per-client ``host`` lists."""
        C = len(states)
        ordered = [states[c] for c in range(C)]
        trainable = stack_trees([s.theta for s in ordered])
        extras: Dict[str, Any] = {}
        host: Dict[str, List[Any]] = {}
        for k in ordered[0].extras:
            vals = [s.extras[k] for s in ordered]
            if _is_stackable(vals[0]):
                extras[k] = stack_trees(vals)
            else:
                host[k] = vals
        return StackedClientState(n_clients=C, trainable=trainable,
                                  opt_state=self.opt.init(trainable),
                                  extras=extras, host=host)

    def client_view(self, stacked: StackedClientState, c: int) -> ClientState:
        """Client c's slice of the stacked state (storage accounting)."""
        ex = {k: tree_map(lambda x: x[c], v) for k, v in stacked.extras.items()}
        for k, vals in stacked.host.items():
            ex[k] = vals[c]
        return ClientState(theta=tree_map(lambda x: x[c], stacked.trainable),
                           extras=ex)

    def storage_bytes(self, state: ClientState) -> int:
        return tree_bytes(state.theta)

    # ---- local round ---------------------------------------------------------
    def _gather_rehearsal(self, stacked: StackedClientState, c: int):
        """Client c's rehearsal pool for this round (None = none), drawn
        first in that client's rng order."""
        return None

    def gather_round_batches(self, stacked: StackedClientState, protos_list,
                             labels_list, device) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
        """(C, epochs, B, D) fp32 prototypes + (C, epochs, B) int64 labels
        on ``device``, drawn in the reference's order."""
        bxs, bys = [], []
        for c in range(len(protos_list)):
            p, l = protos_list[c], labels_list[c]
            n = len(p)
            reh = self._gather_rehearsal(stacked, c)
            ex, ey = [], []
            for _ in range(self.epochs):
                idx = self.rng.choice(n, size=min(self.batch, n),
                                      replace=n < self.batch)
                px, py = p[idx], l[idx]
                if reh is not None:
                    rx, ry = reh
                    ridx = self.rng.choice(len(rx), size=self.batch // 2,
                                           replace=True)
                    px = np.concatenate([px, rx[ridx]])
                    py = np.concatenate([py, ry[ridx]])
                ex.append(px)
                ey.append(py)
            bxs.append(np.stack(ex))
            bys.append(np.stack(ey))
        shapes = {b.shape for b in bxs}
        if len(shapes) > 1:
            raise ValueError(
                f"stacked engine needs uniform per-client batch shapes, "
                f"got {sorted(shapes)} (ragged tasks/rehearsal pools)")
        bx = torch.from_numpy(np.stack(bxs).astype(np.float32))
        by = torch.from_numpy(np.stack(bys).astype(np.int64))
        return bx.to(device), by.to(device)

    def _loss_extras(self, stacked: StackedClientState):
        return {k: v for k, v in stacked.extras.items() if k.startswith("reg_")}

    def local_train_stacked(self, stacked: StackedClientState, bx, by,
                            protos_list, labels_list, rnd: int):
        """Train all C clients, one stacked step per epoch. Returns
        (stacked state, stacked upload or None)."""
        extras = self._loss_extras(stacked)
        trainable, opt_state = stacked.trainable, stacked.opt_state
        for e in range(bx.shape[1]):
            tr = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
            total = torch.sum(self.loss(tr, bx[:, e], by[:, e], extras)
                              + self.regularizer(tr, extras))
            total.backward()
            with torch.no_grad():
                grads, _ = clip_by_global_norm(tree_map(lambda t: t.grad, tr),
                                               1.0)
                updates, opt_state = self.opt.update(grads, opt_state,
                                                     trainable)
                trainable = apply_updates(trainable, updates)
        stacked.trainable = trainable
        stacked.opt_state = opt_state
        return stacked, None

    # ---- evaluation and byte accounting --------------------------------------
    def eval_theta_stacked(self, stacked: StackedClientState):
        """The (C, ...) eval-time heads, straight off the stacked state."""
        return stacked.trainable

    def stacked_upload_bytes(self, upload, n_clients: int) -> int:
        """Per-client C2S bytes (stacked leaves carry C copies)."""
        return tree_bytes(upload) // max(n_clients, 1)

    # ---- wire codecs ---------------------------------------------------------
    # What part of a payload goes through the (lossy) codec and what ships
    # verbatim. Default: everything is codec traffic.

    def split_upload_for_wire(self, upload) -> Tuple[Any, Any]:
        """(codec subtree, verbatim subtree or None) of an upload."""
        return upload, None

    def join_upload_from_wire(self, decoded, verbatim):
        return decoded

    def split_dispatch_for_wire(self, dispatch) -> Tuple[Any, Any]:
        return dispatch, None

    def join_dispatch_from_wire(self, decoded, verbatim):
        return decoded

    def _stacked_wire_program(self, which: str, p: int) -> BatchedCodec:
        """The device codec program of one direction at payload size p,
        built once per simulation (p is fixed by the model)."""
        key = (which, p)
        if key not in self._wire_programs:
            template = (self.upload_codec if which == "upload"
                        else self.dispatch_codec)
            self._wire_programs[key] = BatchedCodec(template, p)
        return self._wire_programs[key]

    def _wire_roundtrip_stacked(self, which, tree, split, join):
        """All C clients' payload rows through one batched encode + decode;
        per-client bytes come from the encoded buffers' shapes, plus the
        verbatim subtree's share. Returns (the receiver-visible payload,
        measured bytes per client)."""
        lossy, verbatim = split(tree)
        mat, meta = tree_flatten_stacked(lossy)
        C = mat.shape[0]
        prog = self._stacked_wire_program(which, int(mat.shape[1]))
        with torch.no_grad():
            recon, buffers = prog.roundtrip(mat)
        per_client = prog.per_client_bytes(buffers)
        if verbatim is not None:
            per_client += tree_bytes(verbatim) // max(C, 1)
        return join(tree_unflatten_stacked(recon, meta), verbatim), per_client

    def wire_upload_stacked(self, upload):
        """C2S: the stacked upload through the upload codec."""
        return self._wire_roundtrip_stacked(
            "upload", upload, self.split_upload_for_wire,
            self.join_upload_from_wire)

    def wire_dispatch_stacked(self, dispatch):
        """S2C: the stacked dispatch through the dispatch codec (a broadcast
        stream: all C rows every dispatch round)."""
        return self._wire_roundtrip_stacked(
            "dispatch", dispatch, self.split_dispatch_for_wire,
            self.join_dispatch_from_wire)
