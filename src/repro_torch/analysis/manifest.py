"""Manifest: registers the programs the port builds inside methods (the
port of ``repro/analysis/manifest.py``).

The decorator in ``registry`` covers module-level programs; the engines'
hottest programs, though, run inside methods: the stacked server round
(``FedSTIL.server_round_stacked``: the ring push and relevance of
``DeviceRingHistory``, the flatten, the fused aggregate, the unflatten),
the stacked local train (``Strategy.train_epochs_stacked``) and the wire
codec's stages (``BatchedCodec._enc_sparse`` / ``_enc_dense`` / ``_dec``).
This module composes each one's device part from the same production
functions, with tiny concrete configs for the structures (an example head,
the stacked state's trees), and registers it under the reference's name at
the reference's C=100 shapes. The server round's one host readback
(``last_W``) is not part of its program.

The sharded programs run on a one-rank engine mesh: on meta in a fake
world of one (``launch.mesh.fake_world``; a process holds one default
group, so none may be up), on a card in the run's world
(``sharding.specs.engine_world``: joined if up, else made for the call).

Importing this module (``registry.load_all()`` does) performs the
registrations; everything here is host-side init at toy sizes, nothing
runs.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.analysis.registry import (meta, meta_like,
                                           register_runtime)

# the reference's bench-scale abstract sizes
_C = 100
_HIST = 6


@contextlib.contextmanager
def one_rank_mesh(device: torch.device):
    """A one-rank engine mesh on ``device`` (module docstring)."""
    from repro_torch.launch.mesh import fake_world
    from repro_torch.sharding.specs import engine_mesh, engine_world
    if device.type != "meta":
        world = engine_world(device)
    elif dist.is_initialized():
        world = contextlib.nullcontext()
    else:
        world = fake_world(1)
    with world, engine_mesh(device=device) as mesh:
        yield mesh


def _register_fedstil() -> None:
    from repro_torch.common.precision import WIRE_CASTS
    from repro_torch.common.pytree import flatten_stacked, unflatten_stacked
    from repro_torch.core import edge_model as EM
    from repro_torch.core.fedstil import FedSTIL, _ShardedServer, _StackedServer
    from repro_torch.core.relevance import ring_push, ring_relevance

    cfg = EM.EdgeModelConfig()
    D = cfg.proto_dim
    strat = FedSTIL(cfg, n_clients=_C, epochs=2)
    # tiny concrete states give the stacked trees' structure (the optimizer
    # state, the extras); the abstract args re-shape them to _C rows
    C0 = 4
    gen = torch.Generator().manual_seed(0)
    stacked = strat.stack_states({c: strat.init_client(
        EM.init_adaptive_layers(cfg, gen)) for c in range(C0)})
    theta_example = strat.eval_theta_stacked(stacked)     # (C0, ...) heads
    _, flat_meta = flatten_stacked(theta_example)
    P = sum(int(t[0].numel()) for t in theta_example.values())

    def ring_args():
        return (meta(_C, _HIST, D), meta(_C, _HIST), meta(_C), meta(_C, D),
                meta(_C))

    def relevance(buf, valid, stale, feats, mask):
        """The ring push and Eq. 4/5 (``DeviceRingHistory.push_all`` and
        ``raw_relevance``): -> (buf, valid, stale, raw W)."""
        buf, valid, stale = ring_push(buf, valid, stale, feats, mask)
        return buf, valid, stale, ring_relevance(
            buf, valid, forgetting_ratio=strat.forgetting_ratio,
            metric=strat.metric)

    register_runtime(
        "federated.fedstil_server_relevance", relevance,
        abstract_args=lambda: (ring_args(), {}),
        module="repro_torch.core.fedstil",
        oracle="repro_torch.core.relevance.RelevanceTracker.relevance",
        carry=(0, 1, 2), donate=(0, 1, 2), budget_bytes=64 << 20)

    def server_round(buf, valid, stale, feats, mask, theta_flat):
        """The stacked server round's device part (``FedSTIL.
        server_round_stacked``): ring push + Eq. 4/5, the fused Eq. 5 -> 6
        kernel, unflatten, and the nz row mask."""
        buf, valid, stale, w_raw = relevance(buf, valid, stale, feats, mask)
        b_flat, _, wn = _StackedServer.aggregate(w_raw, theta_flat)
        return (buf, valid, stale, unflatten_stacked(b_flat, flat_meta),
                torch.sum(wn, 1) > 0)

    register_runtime(
        "federated.fedstil_server_round", server_round,
        abstract_args=lambda: (ring_args() + (meta(_C, P),), {}),
        module="repro_torch.core.fedstil",
        oracle="repro_torch.core.fedstil.FedSTIL.server_round",
        carry=(0, 1, 2), donate=(0, 1, 2), budget_bytes=128 << 20)

    def sharded_server_round(buf, valid, stale, feats, mask, theta):
        """The same round on the sharded engine (``_ShardedServer`` over a
        one-rank mesh, ``mask`` the rows' validity): the features
        gathered, the flatten cast to the bf16 wire and back to fp32 for
        ``sharded_fused_aggregate``. The f32 -> bf16 -> f32 pair is the
        sanctioned wire cast of common/precision.py, not convert churn."""
        with one_rank_mesh(feats.device) as mesh:
            io = _ShardedServer(mesh, mask, strat.wire_dtype)
            feats, mask = io.gather(feats)
            buf, valid, stale, w_raw = relevance(buf, valid, stale, feats,
                                                 mask)
            flat, fmeta = flatten_stacked(theta)
            b_flat, _, wn_mine = io.aggregate(w_raw, io.wire(flat))
            return (buf, valid, stale, unflatten_stacked(b_flat, fmeta),
                    torch.sum(wn_mine, 1) > 0)

    register_runtime(
        "federated.sharded_server_round", sharded_server_round,
        abstract_args=lambda: (
            ring_args() + (meta_like(theta_example, lead=_C),), {}),
        module="repro_torch.core.fedstil",
        oracle="repro_torch.core.fedstil.FedSTIL.server_round",
        carry=(0, 1, 2), donate=(0, 1, 2), budget_bytes=128 << 20,
        sanctioned_casts=WIRE_CASTS)

    epochs, batch = strat.epochs, strat.batch
    register_runtime(
        "federated.stacked_local_train", strat.train_epochs_stacked,
        abstract_args=lambda: ((
            meta_like(stacked.trainable, lead=_C),
            meta_like(stacked.opt_state, lead=_C),
            meta_like(strat._stacked_loss_extras(stacked), lead=_C),
            meta(_C, epochs, batch, D),
            meta(_C, epochs, batch, dtype=torch.int64)), {}),
        module="repro_torch.federated.base",
        oracle="repro_torch.federated.base.Strategy._run_epochs",
        carry=(0, 1), donate=(0, 1), budget_bytes=640 << 20)

    # the flatten stage rides along, as in the reference
    register_runtime(
        "federated.fedstil_server_flatten",
        lambda theta: flatten_stacked(theta)[0],
        abstract_args=lambda: ((meta_like(theta_example, lead=_C),), {}),
        module="repro_torch.core.fedstil",
        oracle="repro_torch.common.pytree.tree_flatten_stacked",
        budget_bytes=128 << 20)


def _register_comm() -> None:
    from repro_torch.comm.batched import BatchedCodec
    from repro_torch.comm.codec import make_codec

    P = 4096
    codec = BatchedCodec(make_codec("topk+int8"), P)

    register_runtime(
        "comm.batched_encode", codec._enc_sparse,
        abstract_args=lambda: ((meta(_C, P),), {}),
        module="repro_torch.comm.batched",
        oracle="repro_torch.comm.codec.PipelineCodec.encode",
        budget_bytes=32 << 20)
    register_runtime(
        "comm.batched_encode_keyframe", codec._enc_dense,
        abstract_args=lambda: ((meta(_C, P),), {}),
        module="repro_torch.comm.batched",
        oracle="repro_torch.comm.codec.PipelineCodec.encode",
        budget_bytes=32 << 20)
    # the decode's buffers: the sparse encode's outputs, on meta
    register_runtime(
        "comm.batched_decode", codec._dec,
        abstract_args=lambda: ((codec._enc_sparse(meta(_C, P))[0],), {}),
        module="repro_torch.comm.batched",
        oracle="repro_torch.comm.codec.PipelineCodec.decode",
        budget_bytes=32 << 20)


def _register_sharded() -> None:
    # the engine's standalone sharded programs (the launchers are thin
    # harnesses around these: one sharded implementation)
    from repro_torch.core import edge_model as EM
    from repro_torch.core.fedstil import sharded_fused_aggregate
    from repro_torch.federated.base import sharded_eval

    def sharded_aggregate(w, thetas):
        with one_rank_mesh(w.device) as mesh:
            return sharded_fused_aggregate(w, thetas, mesh)

    register_runtime(
        "federated.sharded_aggregate", sharded_aggregate,
        abstract_args=lambda: ((meta(_C, _C), meta(_C, 4096)), {}),
        module="repro_torch.core.fedstil",
        oracle="repro_torch.kernels.ref.fused_relevance_aggregate_ref",
        budget_bytes=64 << 20)

    def sharded_eval_program(*args, **kw):
        with one_rank_mesh(args[1].device) as mesh:
            return sharded_eval(mesh, *args, **kw)

    cfg = EM.EdgeModelConfig()
    C, T, Q, G, D = 8, 3, 16, 96, cfg.proto_dim
    i32 = torch.int32
    register_runtime(
        "federated.sharded_eval", sharded_eval_program,
        abstract_args=lambda: ((
            EM.adaptive_layers_meta(cfg, C), meta(C, T, Q, D),
            meta(C, T, Q, dtype=i32), meta(C, T), meta(C, G, D),
            meta(C, G, dtype=i32), meta(C, G)), {}),
        module="repro_torch.federated.base",
        oracle="repro_torch.federated.simulation._eval_round",
        budget_bytes=64 << 20)


_register_fedstil()
_register_comm()
_register_sharded()
