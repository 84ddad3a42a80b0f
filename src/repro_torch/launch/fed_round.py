"""The FedSTIL parameter server as a collective program over a mesh.

The port of ``repro/launch/fed_round.py``. At fleet scale the "parameter
server" is not a process: clients live along the "data" axis (one edge
client a data rank; pods = spatial regions), their adaptive heads may be
split over the "model" axis, and one federated round (paper Algorithm 1,
lines 5-9) is one SPMD program that every rank runs:

  1. every client's task history is all-gathered over the client axis
     (tiny: k x proto_dim floats a client);
  2. task similarity (Eq. 4, KL) and the decayed relevance row (Eq. 5) of
     the rank's client are computed, and the rows all-gathered into the
     replicated (C, C) W;
  3. the personalized aggregation B_i = sum_j W_ij theta_j (Eq. 6) is ONE
     reduce-scatter over the client axis: client j contributes
     W[:, j] * theta_j and receives exactly its own B_j. Bytes a client =
     (C - 1) / C * C * |theta|, the WAN cost of the paper's Table II.

On the CPU the demos spawn their own gloo world (``launch.mesh.spawn``;
8 ranks, a (4, 2) mesh), each rank checks its rows against the batched
parameter server (``core.relevance`` and the Eq. 6 aggregate) and rank 0
prints:

  PYTHONPATH=src python -m repro_torch.launch.fed_round --demo \\
      --stacked-demo --device cpu
  torchrun --nproc-per-node 8 -m repro_torch.launch.fed_round --demo \\
      --device cpu          # the same inside a torchrun world

On the card (the default device) the world is ``torchrun``'s, one card a
rank, or one process a card (``--world``, default: every visible card).
``--trace out.jsonl`` records a ``repro_torch.obs`` span per action on rank
0 (read it with ``python -m repro_torch.obs.report out.jsonl``).
``--arch`` lowers an LM's federated round onto the production mesh
(16 x 16, or 2 x 16 x 16 with ``--multi-pod``): one client a "data" (and
"pod") rank, each client's adaptive tree (``steps.abstract_train_state``'s
B) split over "model" by ``tree_param_specs``, D = 256, k = 6. Rank 0's
``fed_round`` (``fed_round_hierarchical``) runs on meta tensors in a fake
world (``launch.mesh.fake_world``) under ``sharding.analysis.OpCounter``,
and the launcher prints the adaptive payload per client and the
collective bytes per device by kind:

  PYTHONPATH=src python -m repro_torch.launch.fed_round --arch qwen3-1.7b \
      [--multi-pod]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.pytree import (tree_flatten_stacked, tree_leaves,
                                       tree_map, tree_unflatten_stacked)
from repro_torch.core.fedstil import sharded_fused_aggregate
from repro_torch.core.relevance import decayed_relevance, normalize_rows
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import abstract_train_state
from repro_torch.obs import trace as obs
from repro_torch.sharding import specs as S
from repro_torch.sharding.analysis import OpCounter


def fed_round(theta_local, task_feature_local, hist_features_local, *, mesh,
              client_axis: str = "data", forgetting_ratio: float = 0.5):
    """One FedSTIL round on every rank of ``mesh``, one client a rank of
    ``client_axis``.

    theta_local: this client's head (a tensor or a dict of tensors; its
        leaves may be this rank's block of a "model"-split head: the
        aggregation is elementwise per parameter, so model ranks aggregate
        their blocks independently, with no model-axis collective);
    task_feature_local: (D,) this client's current task feature;
    hist_features_local: (k, D) its last k task features, most recent last.
    Returns (B_local, this client's personalized base, shaped as theta;
    w_row, (C,) its normalized relevance row)."""
    me = mesh.coords[client_axis]
    hist = mesh.all_gather_rows(hist_features_local[None], client_axis)
    C, k = hist.shape[0], hist.shape[1]
    # Eq. 4/5 of MY current task against THEIR histories (most recent
    # last, so the decay runs backwards)
    decay = forgetting_ratio ** torch.arange(k - 1, -1, -1,
                                             dtype=torch.float32,
                                             device=hist.device)
    w_row = decayed_relevance(task_feature_local[None], hist, decay,
                              metric="kl")[0]
    w_row = torch.where(torch.arange(C, device=w_row.device) == me,
                        torch.zeros((), device=w_row.device), w_row)
    w_row = w_row / torch.clamp(torch.sum(w_row), min=1e-9)
    # every j needs its column: gather the rows into the (C, C) W
    W = mesh.all_gather_rows(w_row[None], client_axis)
    # Eq. 6 as ONE reduce-scatter: my share of every destination i is
    # W[i, me] * theta_me
    flat, meta = tree_flatten_stacked(tree_map(lambda t: t[None],
                                               theta_local))
    contrib = W[:, me][:, None] * flat                          # (C, P_loc)
    mine = mesh.reduce_scatter_rows(contrib, client_axis)       # (1, P_loc)
    B_local = tree_map(lambda t: t[0], tree_unflatten_stacked(mine, meta))
    return B_local, w_row


def fed_round_hierarchical(theta_local, task_feature_local,
                           hist_features_local, *, mesh,
                           client_axis: str = "data", pod_axis: str = "pod",
                           beta: float = 0.25, forgetting_ratio: float = 0.5):
    """Multi-pod FedSTIL: pods = spatial regions of edge clients. Within a
    pod, the full Eq. 4-6 round over its clients; across pods, one mean of
    the bases over ``pod_axis``, mixed in with weight ``beta``: distant
    regions share general knowledge while the fine-grained relevance stays
    in the region, and cross-pod traffic is |theta| a round."""
    B_local, w_row = fed_round(theta_local, task_feature_local,
                               hist_features_local, mesh=mesh,
                               client_axis=client_axis,
                               forgetting_ratio=forgetting_ratio)
    npod = mesh.size(pod_axis)
    B_mixed = tree_map(
        lambda b: (1.0 - beta) * b + beta * (mesh.all_sum(b, pod_axis) / npod),
        B_local)
    return B_mixed, w_row


def server_oracle(thetas, feats, hists, forgetting_ratio: float = 0.5):
    """The batched parameter server on global numpy inputs: thetas (C, P),
    feats (C, D), hists (C, k, D) most recent last -> (W (C, C), B (C, P))
    numpy, through ``core.relevance`` and the Eq. 6 aggregate."""
    k = hists.shape[1]
    decay = forgetting_ratio ** torch.arange(k - 1, -1, -1,
                                             dtype=torch.float32)
    W = decayed_relevance(torch.from_numpy(feats), torch.from_numpy(hists),
                          decay, metric="kl").numpy()
    np.fill_diagonal(W, 0.0)
    W = normalize_rows(W)
    B = ops.relevance_aggregate(torch.from_numpy(W),
                                torch.from_numpy(thetas)).numpy()
    return W, B


def demo_inputs(C: int, D: int, P: int, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, P)).astype(np.float32),
            rng.standard_normal((C, D)).astype(np.float32),
            rng.standard_normal((C, k, D)).astype(np.float32))


def _demo(mesh):
    """4 clients on "data" (one a rank), each head's 64 columns split over
    "model": every rank's W row and B block match the batched parameter
    server's."""
    C = mesh.size("data")
    thetas, feats, hists = demo_inputs(C, 16, 64, 3)
    me = mesh.coords["data"]
    th = S.place(torch.from_numpy(thetas), ("data", "model"), mesh)[0]
    B, w_row = fed_round({"w": th},
                         torch.from_numpy(feats[me]).to(mesh.device),
                         torch.from_numpy(hists[me]).to(mesh.device),
                         mesh=mesh)
    Wref, Bref = server_oracle(thetas, feats, hists)
    lo, hi = mesh.block(thetas.shape[1], "model")
    np.testing.assert_allclose(w_row.cpu().numpy(), Wref[me], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(B["w"].cpu().numpy(), Bref[me, lo:hi],
                               rtol=1e-3, atol=1e-4)
    W = mesh.all_gather_rows(w_row[None]).cpu().numpy()
    if mesh.rank == 0:
        print("fed_round on-mesh == batched parameter server  (W, B match)")
        print("W =\n", np.round(W, 3))


def _stacked_demo(mesh, C: int = 64, P: int = 4096):
    """C clients split over "data", P over "model": the engine's sharded
    aggregate matches the one-device kernel path on every rank's block."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(np.abs(rng.standard_normal((C, C))).astype(
        np.float32)).to(mesh.device)
    thetas = torch.from_numpy(rng.standard_normal((C, P)).astype(np.float32))
    B, Wn = sharded_fused_aggregate(
        w, S.place(thetas, ("data", "model"), mesh), mesh)
    Bref, Wnref = ops.fused_relevance_aggregate(w, thetas.to(mesh.device))
    torch.testing.assert_close(Wn, Wnref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(B, S.place(Bref, ("data", "model"), mesh),
                               rtol=1e-4, atol=1e-5)
    if mesh.rank == 0:
        print(f"sharded fused aggregate (C={C} over data x "
              f"{mesh.size('data')}, P={P} over model x "
              f"{mesh.size('model')}) == kernel path")


ROUND_D, ROUND_K = 256, 6


def lower_round(cfg, mesh, *, multi_pod: bool, D: int = ROUND_D,
                k: int = ROUND_K):
    """This rank's part of one federated round of ``cfg``'s adaptive heads
    on ``mesh`` (one client a "data" rank, and a "pod" rank with
    ``multi_pod``; each head split over "model"), on the mesh's device
    (zeros; meta in a fake world), under an ``OpCounter`` -> (the counter,
    the global head ``B0``, a tree of meta tensors)."""
    tp = mesh.size("model")
    _, B0, _, _ = abstract_train_state(cfg, tp)
    # the client axis holds whole clients: no FSDP split of a head over it
    specs = S.tree_param_specs(cfg, B0, tp_size=tp, fsdp_axis=None)
    th = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                        device=mesh.device),
                  S.shard_tree(B0, specs, mesh))
    feat = torch.zeros(D, device=mesh.device)
    hist = torch.zeros((k, D), device=mesh.device)
    with OpCounter() as counter:
        if multi_pod:
            fed_round_hierarchical(th, feat, hist, mesh=mesh,
                                   client_axis="data", pod_axis="pod")
        else:
            fed_round(th, feat, hist, mesh=mesh, client_axis="data")
    return counter, B0


def payload_bytes(B0) -> int:
    """The adaptive payload of one client: the bytes of its whole head."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(B0))


def _lower(arch: str, multi_pod: bool):
    """Lower a production federated round: 16 clients (data axis; 32 over
    two pods), each client's adaptive layers TP-split over the model
    axis; print its payload and collectives."""
    cfg = get_config(arch)
    with M.fake_world(512 if multi_pod else 256):
        with M.make_production_mesh(multi_pod=multi_pod, device="meta",
                                    model=16) as mesh:
            counter, B0 = lower_round(cfg, mesh, multi_pod=multi_pod)
    stats = counter.stats()
    print(f"fed_round lowered for {arch} on "
          f"{'2x16x16' if multi_pod else '16x16'}")
    print(f"  adaptive payload/client: {payload_bytes(B0) / 1e6:.1f} MB")
    print(f"  collective bytes/device: {stats.total_bytes / 1e6:.2f} MB "
          f"{stats.count_by_kind}")
    print(f"  bytes by kind: {stats.bytes_by_kind}")
    return counter, B0


def _ranks(demo: bool, stacked_demo: bool, device: str, trace):
    """Every rank's part: the demos on a (world / 2, 2) mesh (world x 1 for
    an odd world), traced on rank 0."""
    n = dist.get_world_size()
    tp = 2 if n % 2 == 0 else 1
    with M.make_debug_mesh(tp=tp, dp=n // tp, device=device) as mesh:
        tracer = (obs.Tracer(path=trace) if trace and mesh.rank == 0
                  else obs.NullTracer())
        try:
            with obs.active(tracer):
                if stacked_demo:
                    with obs.span("fed_round.stacked_demo", cat="phase"):
                        _stacked_demo(mesh)
                if demo:
                    with obs.span("fed_round.demo", cat="phase"):
                        _demo(mesh)
        finally:
            tracer.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--stacked-demo", action="store_true")
    ap.add_argument("--arch", default=None,
                    help="lower this arch's round onto the production mesh "
                         "(meta tensors in a fake world)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --arch: 2 x 16 x 16, the hierarchical round")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn outside torchrun (default: 8 on "
                         "the CPU, every visible card on cuda)")
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="write a repro_torch.obs telemetry JSONL on rank 0 "
                         "(one span per action); read it with python -m "
                         "repro_torch.obs.report")
    args = ap.parse_args(argv)
    if args.arch:
        # the production lowering: meta tensors in a fake world, no device
        tracer = obs.Tracer(path=args.trace) if args.trace else \
            obs.NullTracer()
        try:
            with obs.active(tracer), obs.span("fed_round.lower", cat="phase",
                                              arch=args.arch):
                _lower(args.arch, args.multi_pod)
        finally:
            tracer.close()
        if not (args.demo or args.stacked_demo):
            return
    demo = args.demo or not args.stacked_demo
    run = (demo, args.stacked_demo, args.device, args.trace)
    if S.torchrun_world(args.device):
        try:
            _ranks(*run)
        finally:
            dist.destroy_process_group()
    else:
        dev = S.world_device(args.device)
        world = args.world or (8 if dev.type == "cpu"
                               else torch.cuda.device_count())
        M.spawn(_ranks, world, *run, device=dev.type)
    if args.trace:
        print(f"telemetry: {args.trace}  "
              f"(python -m repro_torch.obs.report {args.trace})")


if __name__ == "__main__":
    main()
