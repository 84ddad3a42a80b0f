"""Batched retrieval evaluation split over client rows (the C >> 1000 path).

The port of ``repro/launch/eval_round.py``. The batched evaluation
(``federated.base.eval_round_stacked``: the stacked feature heads, every
distance matrix, mAP/CMC on the device) is embarrassingly parallel over
clients: every input leads with C and no stage contracts it. Its one
sharded form is ``federated.base.sharded_eval``, the one the sharded
engine runs: each rank evaluates its block of client rows (placed with
``sharding.specs.stacked_eval_specs``) and one gather over "data" returns
the (C, T) metrics. This launcher is a demo around it: every rank checks
the gathered metrics against the one-process evaluation of all rows.

  PYTHONPATH=src python -m repro_torch.launch.eval_round --demo --device cpu
  torchrun --nproc-per-node 4 -m repro_torch.launch.eval_round --device cpu

On the CPU it spawns its own gloo world (``launch.mesh.spawn``, 4 ranks);
on the card the world is ``torchrun``'s, or one process a visible card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import edge_model as EM
from repro_torch.federated.base import eval_round_stacked, sharded_eval
from repro_torch.launch import mesh as M
from repro_torch.sharding import specs as S


def demo_inputs(C: int = 8, T: int = 3, Q: int = 16, G: int = 96,
                seed: int = 0):
    """A stacked head and (C, T) query sets / (C, G) galleries, numpy."""
    cfg = EM.EdgeModelConfig()
    gen = torch.Generator().manual_seed(seed)
    heads = [EM.init_adaptive_layers(cfg, gen) for _ in range(C)]
    theta = {k: np.stack([h[k].numpy() for h in heads]) for k in heads[0]}
    rng = np.random.default_rng(seed)
    D = cfg.proto_dim
    task_mask = np.broadcast_to((np.arange(T) < 2).astype(np.float32), (C, T))
    return {"theta": theta,
            "qf": rng.standard_normal((C, T, Q, D)).astype(np.float32),
            "qids": rng.integers(0, 30, (C, T, Q)),
            "task_mask": np.ascontiguousarray(task_mask),
            "gf": rng.standard_normal((C, G, D)).astype(np.float32),
            "gids": rng.integers(0, 30, (C, G)),
            "gmask": (rng.random((C, G)) < 0.9).astype(np.float32)}


def evaluate(mesh, inputs):
    """The sharded evaluation of global numpy ``inputs`` (``demo_inputs``'
    keys) on ``mesh``: every rank places its rows, evaluates them and
    returns the gathered (C, T) metrics as numpy."""
    sp = S.stacked_eval_specs()
    t = lambda a: torch.from_numpy(np.asarray(a))
    theta = S.place_tree({k: t(v) for k, v in inputs["theta"].items()},
                         S.stacked_eval_theta_specs(
                             {k: t(v) for k, v in inputs["theta"].items()}),
                         mesh)
    args = [S.place(t(inputs[k]), sp[k], mesh)
            for k in ("qf", "qids", "task_mask", "gf", "gids", "gmask")]
    out = sharded_eval(mesh, theta, *args)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _demo(device: str):
    inputs = demo_inputs()
    with M.make_debug_mesh(tp=1, dp=dist.get_world_size(),
                           device=device) as mesh:
        out = evaluate(mesh, inputs)
        rank, d = mesh.rank, mesh.size("data")
    ref = eval_round_stacked(
        {k: torch.from_numpy(v) for k, v in inputs["theta"].items()},
        *(torch.from_numpy(np.asarray(inputs[k]))
          for k in ("qf", "qids", "task_mask", "gf", "gids", "gmask")))
    for k, v in ref.items():
        np.testing.assert_allclose(out[k], v.numpy(), atol=1e-5)
    if rank == 0:
        C = out["mAP"].shape[0]
        print(f"sharded eval round (C={C} over data x {d}) "
              f"== one-process evaluation; mean mAP="
              f"{float(np.mean(out['mAP'])):.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn outside torchrun (default: 4 on "
                         "the CPU, every visible card on cuda)")
    args = ap.parse_args(argv)
    if S.torchrun_world(args.device):
        try:
            _demo(args.device)
        finally:
            dist.destroy_process_group()
        return
    dev = S.world_device(args.device)
    world = args.world or (4 if dev.type == "cpu"
                           else torch.cuda.device_count())
    M.spawn(_demo, world, args.device, device=dev.type)


if __name__ == "__main__":
    main()
