"""Shared machinery of the federated strategies, both engines.

The port of ``repro/federated/base.py``. A strategy owns per-client state
and three host-engine hooks:

    local_train(client, state, protos, labels, rnd)  -> state, upload
    server_round(rnd, uploads)                       -> dispatches
    apply_dispatch(state, dispatch)                  -> state

which the host engine (``run_simulation(engine="host")``, the reference's
default) drives one client at a time: ``_run_epochs`` draws each epoch's
minibatch (and rehearsal rows) from ``self.rng`` in the reference's order
and takes one clipped Adam step on the client's head, run as a stack of
one through the same batched forwards as the stacked engine; uploads and
dispatches optionally cross a host wire codec (``comm.codec``, one peer per
client and direction).

Strategies with ``supports_stacked`` also implement the stacked engine:
all C clients' trainable parameters, optimizer states and array extras
live as one tree of ``(C, ...)`` tensors (``StackedClientState``);
per-client objects that cannot be stacked (rehearsal memories) stay in
per-client ``host`` lists. A stacked round is:

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

The sharded engine (``run_simulation(engine="sharded")``) runs the same
stacked round on each rank of a ``torch.distributed`` world over the
rank's block of client rows (``sharding.specs``): ``shard_stacked_state``
pads the stacked state to Cp rows (``pad_client_rows``) and keeps the
rank's block, ``place_rows`` does the same to each round's minibatches
(drawn for all C clients on every rank, so the rng stream stays one), the
server round gets the rows' validity mask, and ``sharded_eval`` evaluates
the rank's rows and gathers the (Cp, T) metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.registry import meta, register_program
from repro_torch.comm.batched import BatchedCodec
from repro_torch.comm.codec import make_codec
from repro_torch.common.pytree import (device_of, tree_bytes,
                                       tree_flatten_stacked, tree_map,
                                       tree_slice, tree_stack,
                                       tree_unflatten_stacked)
from repro_torch.core import edge_model as EM
from repro_torch.evalreid.batched import _PAD_QID, batched_retrieval_metrics
from repro_torch.obs import trace as obs
from repro_torch.sharding import specs as shard_specs
from repro_torch.train.optimizer import adam, apply_updates, clip_by_global_norm


@dataclasses.dataclass
class ClientState:
    """One client's state: the host engine's unit, the stacked engine's
    input (and its view of one client)."""

    theta: Any                        # the trainable tree (strategy-defined)
    opt_state: Any = None             # Adam's state, a stack of one (host)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StackedClientState:
    """All C clients' states as one tree of (C, ...) tensors; ``host``
    keeps per-client objects as length-C lists. On the sharded engine the
    tensors hold this rank's block of the Cp padded rows, the first of
    them client ``row0``; ``host`` keeps all C real clients."""

    n_clients: int
    trainable: Any
    opt_state: Any
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    host: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)
    row0: int = 0


def _is_stackable(value) -> bool:
    return isinstance(value, (dict, torch.Tensor))


def as_one(tree):
    """A client's tree as a stack of one: every leaf gains a leading 1."""
    return tree_map(lambda t: t[None], tree)


def forward_one(theta, protos) -> np.ndarray:
    """One client's head on (N, D) host prototypes -> (N, feat_dim) host
    features, BN over the whole batch (``adaptive_forward`` of the
    reference), run as a stack of one."""
    dev = device_of(theta)
    with torch.no_grad():
        x = torch.from_numpy(np.asarray(protos, np.float32))[None].to(dev)
        return EM.adaptive_forward(as_one(theta), x)[0][0].cpu().numpy()


# Importances are taken over chunks of this many prototypes: BN has no
# gradient at a batch of 1 (the reference's ``_fisher`` / ``_importance``).
CHUNK = 8


def client_sum(t: torch.Tensor) -> torch.Tensor:
    """(C, ...) -> (C,): the sum over every dimension but the stack's."""
    return torch.sum(t.flatten(1), 1)


def tree_copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def chunk_grads(theta, loss_fn, protos, labels=None):
    """Per-chunk gradients of ``loss_fn`` at one client's head, the
    reference's ``jax.vmap(jax.grad(...))`` over chunks: the first
    ``len(protos) // CHUNK * CHUNK`` host prototypes in chunks of
    ``CHUNK``, the head copied once a chunk as a stack, and one backward
    pass over the sum of the (n_chunks,) losses, so each row's gradient is
    its own chunk's. ``loss_fn(th, x)`` or ``loss_fn(th, x, y)`` takes the
    stacked heads, (n_chunks, CHUNK, D) prototypes and (n_chunks, CHUNK)
    labels. Returns a tree of (n_chunks, ...) gradients."""
    dev = device_of(theta)
    n = (len(protos) // CHUNK) * CHUNK
    x = torch.from_numpy(np.asarray(protos[:n], np.float32)).reshape(
        -1, CHUNK, protos.shape[-1]).to(dev)
    args = [x]
    if labels is not None:
        args.append(torch.from_numpy(np.asarray(labels[:n], np.int64))
                    .reshape(-1, CHUNK).to(dev))
    rows = x.shape[0]
    th = tree_map(lambda t: t.detach()[None].repeat(
        (rows,) + (1,) * t.dim()).requires_grad_(True), theta)
    with torch.enable_grad():
        torch.sum(loss_fn(th, *args)).backward()
    return tree_map(lambda t: t.grad, th)


def fisher_diag(theta, protos, labels):
    """The diagonal Fisher of one client's head: the mean over chunks of
    prototypes of each chunk's squared CE gradient (``_fisher`` of the
    reference's FedCurv, ``_importance`` of its EWC)."""
    g = chunk_grads(theta, EM.ce_loss, protos, labels)
    return tree_map(lambda gg: torch.mean(torch.square(gg), 0), g)


def _stacked_eval_abstract():
    """Bench-scale abstract eval-round inputs (C=8 stacked clients)."""
    cfg = EM.EdgeModelConfig()
    C, T, Q, G, D = 8, 3, 16, 96, cfg.proto_dim
    i32 = torch.int32
    return ((EM.adaptive_layers_meta(cfg, C), meta(C, T, Q, D),
             meta(C, T, Q, dtype=i32), meta(C, T), meta(C, G, D),
             meta(C, G, dtype=i32), meta(C, G)),
            {"ranks": (1, 3, 5), "max_matches": 4})


@register_program(
    "federated.stacked_eval", abstract_args=_stacked_eval_abstract,
    oracle="repro_torch.federated.simulation._eval_round",
    budget_bytes=64 << 20)
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


def sharded_eval(mesh, theta, qp, qids, task_mask, gp, gids, gmask, *,
                 ranks=(1, 3, 5), max_matches=None):
    """``eval_round_stacked`` on this rank's block of client rows (every
    input placed with ``sharding.specs.stacked_eval_specs``), then one
    gather over "data" of each (Cp / d, T) metric: every rank returns the
    (Cp, T) metrics of all rows. ``max_matches`` is the global bound.
    The one sharded evaluation of the port: the sharded engine and
    ``launch/eval_round`` both call it."""
    out = eval_round_stacked(theta, qp, qids, task_mask, gp, gids, gmask,
                             ranks=ranks, max_matches=max_matches)
    return {k: mesh.all_gather_rows(v) for k, v in out.items()}


def pad_client_rows(tree, n_to: int):
    """Pad every leaf's leading client dim to ``n_to`` by repeating the
    last row. Repetition, not zeros, keeps padding clients numerically
    boring: their forward and backward passes and eval rows compute real
    values (no 0/0 BN statistics), and the validity mask keeps them from
    ever reaching a real client."""
    def pad(t):
        C = t.shape[0]
        if C == n_to:
            return t
        return torch.cat([t, t[-1:].expand((n_to - C,) + t.shape[1:])])
    return tree_map(pad, tree)


def place_client_rows(tree, mesh, n_to: int, device=None):
    """A stacked (C, ...) tree padded to ``n_to`` rows (``pad_client_rows``),
    of which this rank keeps its block (``sharding.specs``' client-row
    layout) on ``device`` (the mesh's by default)."""
    padded = pad_client_rows(tree, n_to)
    return shard_specs.place_tree(padded, shard_specs.stacked_tree_specs(
        padded), mesh, device)


class Strategy:
    """Base: plain local training (STL). A strategy with ``uses_server``
    defines ``server_round`` and ``apply_dispatch`` (host engine) and, with
    ``supports_stacked``, ``server_round_stacked`` and
    ``apply_dispatch_stacked``."""

    name = "stl"
    uses_server = False
    # opt-in to run_simulation(engine="stacked")
    supports_stacked = False

    def __init__(self, cfg: EM.EdgeModelConfig, *, lr=1e-3, weight_decay=1e-5,
                 epochs=5, batch=64, seed=0, codec=None, codec_opts=None):
        self.cfg = cfg
        self.lr = lr
        self.epochs = epochs
        self.batch = batch
        self.opt = adam(lr=lr, weight_decay=weight_decay)
        self.rng = np.random.default_rng(seed)
        # wire codecs (comm.codec): when set, the simulation encodes every
        # upload and dispatch, logs the MEASURED buffer bytes (the formulas
        # stay as the cross-check), and the receiver trains on the decoded,
        # possibly lossy, payload. One codec per direction, so delta state
        # never crosses streams.
        opts = dict(codec_opts or {})
        self.upload_codec = make_codec(codec, **opts)
        self.dispatch_codec = make_codec(codec, **opts)
        self._wire_programs: Dict[Tuple[str, int], BatchedCodec] = {}
        # engine="sharded": set by bind_mesh (None elsewhere)
        self.mesh: Optional[shard_specs.EngineMesh] = None
        self.padded_clients: Optional[int] = None

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

    def _train_step(self, trainable, opt_state, x, y, extras):
        """One clipped Adam step of a stack of clients: x (C, B, D), y (C,
        B). Each client's gradient is clipped to global norm 1.0 on its
        own. Returns (trainable, opt_state, (C,) losses)."""
        tr = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
        losses = self.loss(tr, x, y, extras) + self.regularizer(tr, extras)
        torch.sum(losses).backward()
        with torch.no_grad():
            grads, _ = clip_by_global_norm(tree_map(lambda t: t.grad, tr), 1.0)
            updates, opt_state = self.opt.update(grads, opt_state, trainable)
            trainable = apply_updates(trainable, updates)
        return trainable, opt_state, losses.detach()

    # ---- host engine: one client at a time -----------------------------------
    def _loss_extras(self, state: ClientState):
        """The client's ``reg_*`` extras as a stack of one (a zero
        ``reg_dummy`` when it has none, as in the reference)."""
        ex = {k: as_one(v) for k, v in state.extras.items()
              if k.startswith("reg_")}
        return ex if ex else {"reg_dummy": torch.zeros(
            (1,), device=device_of(state.theta))}

    def _run_epochs(self, state: ClientState, protos, labels,
                    rehearsal: Optional[Tuple] = None):
        """``epochs`` steps on one client: each epoch draws its minibatch
        (then, with a rehearsal pool, its rehearsal rows) from ``self.rng``
        in the reference's order. ``opt_state=None`` starts a fresh Adam.
        Returns (state, the last step's loss as a (1,) tensor)."""
        dev = device_of(state.theta)
        trainable = as_one(state.theta)
        opt_state = (self.opt.init(trainable) if state.opt_state is None
                     else state.opt_state)
        extras = self._loss_extras(state)
        n = len(protos)
        loss = None
        for _ in range(self.epochs):
            idx = self.rng.choice(n, size=min(self.batch, n),
                                  replace=n < self.batch)
            px, py = protos[idx], labels[idx]
            if rehearsal is not None:
                rx, ry = rehearsal
                ridx = self.rng.choice(len(rx), size=self.batch // 2,
                                       replace=True)
                px = np.concatenate([px, rx[ridx]])
                py = np.concatenate([py, ry[ridx]])
            x = torch.from_numpy(px.astype(np.float32))[None].to(dev)
            y = torch.from_numpy(py.astype(np.int64))[None].to(dev)
            trainable, opt_state, loss = self._train_step(
                trainable, opt_state, x, y, extras)
        state.theta = tree_slice(trainable, 0)
        state.opt_state = opt_state
        return state, loss

    def init_client(self, theta0) -> ClientState:
        """One client from its initial head (flat dict, no client axis)."""
        return ClientState(theta=theta0)

    def local_train(self, client: int, state: ClientState, protos, labels,
                    rnd: int, **_):
        state, _ = self._run_epochs(state, protos, labels)
        return state, None            # STL uploads nothing

    def server_round(self, rnd: int, uploads: Dict[int, Any]) -> Dict[int, Any]:
        return {}

    def apply_dispatch(self, state: ClientState, dispatch) -> ClientState:
        return state

    def upload_bytes(self, upload) -> int:
        return tree_bytes(upload)

    def dispatch_bytes(self, dispatch) -> int:
        return tree_bytes(dispatch)

    def _eval_theta(self, state: ClientState):
        """The client's eval-time head (identity here; FedSTIL combines)."""
        return state.theta

    def features(self, state: ClientState, protos) -> np.ndarray:
        return forward_one(self._eval_theta(state), protos)

    def stack_eval_thetas(self, states: Dict[int, ClientState]):
        """All C clients' eval-time heads as one (C, ...) tree: the host
        engine's entry to the batched evaluation."""
        return tree_stack([self._eval_theta(states[c])
                           for c in range(len(states))])

    # ---- stacked engine: state -----------------------------------------------

    def stack_states(self, states: Dict[int, ClientState]) -> StackedClientState:
        """Stack C per-client states; array extras go to the device tree,
        everything else to per-client ``host`` lists."""
        C = len(states)
        ordered = [states[c] for c in range(C)]
        trainable = tree_stack([s.theta for s in ordered])
        extras: Dict[str, Any] = {}
        host: Dict[str, List[Any]] = {}
        for k in ordered[0].extras:
            vals = [s.extras[k] for s in ordered]
            if _is_stackable(vals[0]):
                extras[k] = tree_stack(vals)
            else:
                host[k] = vals
        return StackedClientState(n_clients=C, trainable=trainable,
                                  opt_state=self.opt.init(trainable),
                                  extras=extras, host=host)

    def client_view(self, stacked: StackedClientState, c: int) -> ClientState:
        """Client c's slice of the stacked state (storage accounting; on
        the sharded engine c must be one of this rank's rows)."""
        row = c - stacked.row0
        ex = {k: tree_slice(v, row) for k, v in stacked.extras.items()}
        for k, vals in stacked.host.items():
            ex[k] = vals[c]
        return ClientState(theta=tree_slice(stacked.trainable, row),
                           extras=ex)

    # ---- sharded engine: layout ----------------------------------------------
    def shard_stacked_state(self, stacked: StackedClientState, mesh):
        """Pad the stacked state to Cp rows (``padded_clients``) and keep
        this rank's block of them on the mesh's device. Returns (stacked,
        valid), valid the rank's (Cp / d,) rows of the client-validity mask
        (1.0 real, 0.0 padding). Host lists stay length C: padding rows
        have no host-side identity."""
        valid = self.bind_mesh(mesh, stacked.n_clients)
        Cp = self.padded_clients
        stacked.trainable = place_client_rows(stacked.trainable, mesh, Cp)
        stacked.opt_state = place_client_rows(stacked.opt_state, mesh, Cp)
        stacked.extras = {k: place_client_rows(v, mesh, Cp)
                          for k, v in stacked.extras.items()}
        stacked.row0 = mesh.block(Cp)[0]
        return stacked, valid

    def bind_mesh(self, mesh, n_clients: int) -> torch.Tensor:
        """Run this strategy's stacked rounds on ``mesh`` (the sharded
        engine) over ``n_clients`` real clients, padded to Cp
        (``padded_clients``). Returns this rank's (Cp / d,) rows of the
        client-validity mask (1.0 real, 0.0 padding), the ``valid`` of
        ``server_round_stacked``."""
        Cp = shard_specs.padded_clients(n_clients, mesh)
        self.mesh, self.padded_clients = mesh, Cp
        valid = (torch.arange(Cp) < n_clients).float()
        return shard_specs.place(valid, ("data",), mesh)

    def place_rows(self, t: torch.Tensor, device) -> torch.Tensor:
        """A (C, ...) tensor of all real clients (a round's minibatches,
        the reference's ``place_batches``; prototypes, task features) on
        ``device``: on the sharded engine padded to Cp rows first, of which
        the rank keeps its block."""
        if self.mesh is None:
            return t.to(device)
        return place_client_rows(t, self.mesh, self.padded_clients, device)

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
        on ``device``, drawn in the reference's order (``place_rows``: the
        rank's rows on the sharded engine)."""
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
        return self.place_rows(bx, device), self.place_rows(by, device)

    def _stacked_loss_extras(self, stacked: StackedClientState):
        return {k: v for k, v in stacked.extras.items() if k.startswith("reg_")}

    def local_train_stacked(self, stacked: StackedClientState, bx, by,
                            protos_list, labels_list, rnd: int):
        """Train all C clients, one stacked step per epoch. Returns
        (stacked state, stacked upload or None)."""
        stacked.trainable, stacked.opt_state = self.train_epochs_stacked(
            stacked.trainable, stacked.opt_state,
            self._stacked_loss_extras(stacked), bx, by)
        return stacked, None

    def train_epochs_stacked(self, trainable, opt_state, extras, bx, by):
        """One stacked step per epoch of (C, epochs, B, D) ``bx`` and (C,
        epochs, B) ``by`` -> (trainable, opt_state): the device part of
        ``local_train_stacked`` (the reference's ``_stacked_train_fn``)."""
        for e in range(bx.shape[1]):
            trainable, opt_state, _ = self._train_step(
                trainable, opt_state, bx[:, e], by[:, e], extras)
        return trainable, opt_state

    def server_round_stacked(self, rnd: int, upload, valid=None):
        """The server round over the stacked upload (None = no dispatch).
        ``valid`` is the sharded engine's (rows,) client-validity mask of
        this rank's rows (1.0 real, 0.0 padding); None means every row is
        real (the stacked engine)."""
        return None

    def apply_dispatch_stacked(self, stacked: StackedClientState, dispatch):
        return stacked

    # ---- evaluation and byte accounting --------------------------------------
    def eval_theta_stacked(self, stacked: StackedClientState):
        """The (C, ...) eval-time heads, straight off the stacked state."""
        return stacked.trainable

    def stacked_upload_bytes(self, upload, n_clients: int) -> int:
        """Per-client C2S bytes (stacked leaves carry C copies)."""
        return tree_bytes(upload) // max(n_clients, 1)

    def stacked_dispatch_bytes(self, dispatch, n_clients: int) -> int:
        return tree_bytes(dispatch) // max(n_clients, 1)

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

    def _wire_roundtrip(self, codec, tree, split, join, peer):
        """One payload through a host codec (encode and decode in one
        pass). The decoded leaves come back as tensors on the payload's
        device. Returns (the receiver-visible payload, measured bytes, the
        verbatim subtree's included)."""
        lossy, verbatim = split(tree)
        dev = device_of(lossy)
        with obs.span("comm.roundtrip", cat="codec", peer=list(peer)) as sp:
            decoded, payload = codec.roundtrip(lossy, peer=peer)
            decoded = sp.sync(tree_map(lambda a: torch.from_numpy(a).to(dev),
                                       decoded))
        measured = payload.nbytes
        if verbatim is not None:
            measured += tree_bytes(verbatim)
        return join(decoded, verbatim), measured

    def wire_upload(self, upload, client: int):
        """Host-engine C2S wire roundtrip of one client's upload."""
        return self._wire_roundtrip(
            self.upload_codec, upload, self.split_upload_for_wire,
            self.join_upload_from_wire, ("c2s", client))

    def wire_dispatch(self, dispatch, client: int):
        """Host-engine S2C wire roundtrip of one client's dispatch."""
        return self._wire_roundtrip(
            self.dispatch_codec, dispatch, self.split_dispatch_for_wire,
            self.join_dispatch_from_wire, ("s2c", client))

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
        with torch.no_grad(), obs.span(f"comm.{which}", cat="codec") as sp:
            recon, buffers = prog.roundtrip(mat)
            sp.sync(recon)
        # the encode's per-row telemetry (residual norm = decoder-reference
        # staleness, kept energy, keep rate): computed only under a tracer
        obs.metric("comm.encode", prog.last_metrics, direction=which)
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
