"""The production lowering: run every (architecture x input shape x mesh)
step of ``launch/steps.py`` as one rank of the reference's production
meshes, 16 x 16 (256 ranks) and 2 x 16 x 16 (512), and record its
per-device memory, FLOPs and collective bytes beside the H100's roofline.
The port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each step with XLA on 512 host devices
it never runs on. The port runs rank 0's program on meta tensors in a fake
world (``launch.mesh.fake_world``: torch's "fake" process-group backend,
whose collectives move nothing), with ``sharding.analysis.OpCounter``
counting what it dispatches: nothing is allocated and nothing runs on any
device. The record keeps the reference's keys where they mean the same
thing: ``memory`` (``args_bytes_per_device`` from the input specs, the
step's output bytes, and a peak-live-bytes estimate), ``cost`` (counted
FLOPs), ``collectives`` (per-kind ring bytes and counts, plus the split
between groups inside one node of 8 (NVLink) and across nodes),
``roofline`` (``sharding.analysis.Roofline``: counted FLOPs and
collectives, the analytic model's HBM bytes) and ``analytic``
(``sharding.analytic.analytic_roofline`` of the same combo). ``lower_s``
is the traced walk's seconds. Decode steps take the Python int ``pos`` =
seq_len - 1 (long_500k writes its ring slot pos % the window).

Usage (the CPU, a few seconds a combo):
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # 7 x 4 x 2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --multi-pod both --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.sharding import analysis as AN
from repro_torch.sharding.analytic import analytic_roofline
from repro_torch.sharding.specs import shard_tree

MODEL_AXIS = 16


def _tree_device_bytes(tree, specs, mesh_shape) -> int:
    """Per-device bytes of global (meta) tensors under their specs (a
    tensor and its spec tuple, a dict tree and its spec tree, or tuples of
    those)."""
    if isinstance(tree, (tuple, list)):
        return sum(_tree_device_bytes(t, s, mesh_shape)
                   for t, s in zip(tree, specs))
    total = 0
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        div = 1
        for entry in spec:
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                div *= mesh_shape[ax]
        total += (leaf.numel() // max(div, 1)) * leaf.element_size()
    return total


def _bytes(tree) -> int:
    """Bytes of every tensor in a (nested tuple / dict) output."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_bytes(v) for v in tree)
    return 0


def _build(cfg, mesh, shape, shape_name, multi_pod, layout,
           weight_stationary, kv8):
    if shape.mode == "train" and layout != "tp":
        return STEPS.build_train_step(cfg, mesh, shape, multi_pod=multi_pod,
                                      layout=layout)
    if shape.mode == "decode" and (weight_stationary or kv8):
        return STEPS.build_decode_step(
            cfg, mesh, shape, multi_pod=multi_pod,
            weight_stationary=weight_stationary,
            kv_dtype=torch.int8 if kv8 else torch.bfloat16)
    return STEPS.build_step(cfg, mesh, shape_name, multi_pod=multi_pod)


def run_combo(arch: str, shape_name: str, multi_pod: bool, verbose=True,
              layout: str = "tp", weight_stationary: bool = False,
              kv8: bool = False):
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    pods = 2 if multi_pod else 1
    n_dev = pods * 16 * MODEL_AXIS
    t0 = time.time()
    with fake_world(n_dev):
        with make_production_mesh(multi_pod=multi_pod, device="meta",
                                  model=MODEL_AXIS) as mesh:
            step, args, in_specs = _build(cfg, mesh, shape, shape_name,
                                          multi_pod, layout,
                                          weight_stationary, kv8)
            local = [shard_tree(a, s, mesh) for a, s in zip(args, in_specs)]
            if shape.mode == "decode":
                local[3] = shape.seq_len - 1
            with AN.OpCounter() as counter:
                out = step(*local)
            mesh_shape = dict(mesh.shape)
    t_lower = time.time() - t0

    mem = {"args_bytes_per_device": _tree_device_bytes(args, in_specs,
                                                       mesh_shape),
           "output_bytes_per_device": _bytes(out),
           "peak_live_bytes_estimate": counter.peak_live_bytes}
    cost = {"flops": float(counter.flops)}
    coll = counter.stats()
    nvlink = counter.nvlink_bytes()
    analytic = analytic_roofline(cfg, shape, tp=MODEL_AXIS, dp=16, pods=pods,
                                 decode_ws=weight_stationary)
    roof = AN.Roofline(
        flops_per_device=cost["flops"],
        hbm_bytes_per_device=analytic["hbm_bytes_per_device"],
        collective_bytes_per_device=float(coll.total_bytes),
        n_devices=n_dev,
        model_flops=AN.analytic_model_flops(cfg, shape),
        nvlink_bytes_per_device=float(nvlink))

    rec = {
        "arch": arch,
        "shape": shape_name,
        "layout": layout,
        "weight_stationary": weight_stationary,
        "kv8": kv8,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "ok": True,
        "lower_s": round(t_lower, 2),
        "memory": mem,
        "cost": cost,
        "collectives": {"bytes": coll.bytes_by_kind,
                        "count": coll.count_by_kind,
                        "total_bytes": coll.total_bytes,
                        "nvlink_bytes": nvlink,
                        "internode_bytes": coll.total_bytes - nvlink},
        "roofline": roof.as_dict(),
        "hbm_bytes_from": "analytic",
        "analytic": analytic,
    }
    if verbose:
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "lower_s")}), flush=True)
        print(f"  memory: {mem}", flush=True)
        print(f"  counted: flops={cost['flops']:.3e} (analytic "
              f"{analytic['flops_per_device']:.3e}) coll="
              f"{coll.total_bytes:.3e} (nvlink {nvlink:.3e})", flush=True)
        print(f"  roofline: t_comp={roof.t_compute:.4f}s "
              f"t_mem={roof.t_memory:.4f}s t_coll={roof.t_collective:.4f}s "
              f"bottleneck={roof.bottleneck} "
              f"useful={roof.useful_flops_ratio:.3f}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp"],
                    help="dp: model axis carries batch (small-model layout)")
    ap.add_argument("--ws", action="store_true",
                    help="weight-stationary decode (FSDP configs)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"skip {tag} (exists)", flush=True)
                    continue
                try:
                    rec = run_combo(arch, shape, mp, layout=args.layout,
                                    weight_stationary=args.ws, kv8=args.kv8)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "ok": False, "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"dryrun complete; failures={failures}", flush=True)
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
