"""The LM's sharded steps across several cards (NCCL between ranks, one
card a rank): qwen3-1.7b's FedSTIL split step at full width (bf16, B 2 x
S 4096, seed-0 weights) through ``launch/steps.py``'s
``build_train_step`` on (dp, tp) = (1, N) and, for N = 4, (2, 2): the
loss and each adaptive gradient leaf on the mesh against the unsharded
ones on rank 0 (relative L2), then 1 + 3 timed SGD steps beside the
unsharded step's on rank 0 (no clip on either, as under TP);
qwen1.5-0.5b's prefill and 8 decode steps (B 4, a 64-slot cache in the
params' dtype) on (1, N) against the unsharded ones (tokens). One JSON line on stdout,
from rank 0:

    python3 scripts/tp_cards.py [--world 4] [--dtype float32]   # N cards
    PYTHONPATH=src python scripts/tp_cards.py --device cpu --reduced

(the second: a gloo rehearsal on the CPU with the reduced configs).
``--dtype float32`` runs both models in fp32 (the flash kernels' FMA
path), where the sharded and unsharded sums differ in order only.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.common.pytree import leaf_paths, tree_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, spawn  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sharding.specs import gather_tree, shard_tree  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402
from repro_torch.train.optimizer import apply_updates, sgd  # noqa: E402

TIE, STEPS, DECODE_STEPS = 1e-4, 4, 8


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev, n=STEPS):
    """Host ms of n synchronized calls (the first a warm-up); the first
    call's result."""
    ms, first = [], None
    for i in range(n):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        first = out if i == 0 else first
    return ms, first


def configs(reduced, dtype):
    out = [get_config("qwen3-1.7b"), get_config("qwen1.5-0.5b")]
    if reduced:
        out = [c.reduced() for c in out]
    return [dataclasses.replace(c, param_dtype=dtype, compute_dtype=dtype)
            for c in out]


def tokens(cfg, rng, B, S, dev):
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).to(dev)


def train_case(cfg, dev, dp, tp, B, S):
    rank = dist.get_rank()
    st = TR.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             tp=tp)
    rng = np.random.default_rng(0)
    batch = {"tokens": tokens(cfg, rng, B, S, dev),
             "labels": tokens(cfg, rng, B, S, dev)}
    opt = sgd(1.0)
    with make_debug_mesh(tp=tp, dp=dp, device=dev) as mesh:
        step, _, specs = steps.build_train_step(
            cfg, mesh, ShapeConfig("train", S, B, "train"), multi_pod=False,
            optimizer=opt, tie_lambda=TIE)
        args = [shard_tree(a, s, mesh) for a, s in zip(
            (st.frozen, st.B, st.trainable,
             TR.init_opt_state(opt, st.trainable), batch), specs)]
        (loss_mesh, _, _), g_mesh = TR.adaptive_loss_and_grads(
            cfg, args[0], args[1], args[2], args[4], step.ax, tie_lambda=TIE)
        g_mesh = gather_tree(g_mesh, step.out_specs[0], mesh)
        ms, _ = timed(lambda: step(*args)[2]["loss"], dev)
    if rank:
        return None
    (loss, _, _), g = TR.adaptive_loss_and_grads(
        cfg, st.frozen, st.B, st.trainable, batch, tie_lambda=TIE)

    def unsharded():
        _, grads = TR.adaptive_loss_and_grads(
            cfg, st.frozen, st.B, st.trainable, batch, tie_lambda=TIE)
        return apply_updates(st.trainable, opt.update(grads, {})[0])

    ums, _ = timed(unsharded, dev)
    rel = {"/".join(p): float(torch.linalg.vector_norm(a.float() - b.float())
                              / torch.linalg.vector_norm(b.float()))
           for p, a, b in zip(leaf_paths(g), tree_leaves(g_mesh),
                              tree_leaves(g))}
    return {"mesh": {"data": dp, "model": tp}, "loss": [float(loss_mesh),
                                                        float(loss)],
            "grad_rel_l2_worst": max(rel.values()), "grad_rel_l2": rel,
            "step_ms": ms, "median_step_ms": float(np.median(ms[1:])),
            "unsharded_step_ms": ums,
            "unsharded_median_step_ms": float(np.median(ums[1:]))}


def decode_case(cfg, dev, tp, B, S):
    rank = dist.get_rank()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            tp=tp)
    toks = tokens(cfg, np.random.default_rng(1), B, S, dev)
    with make_debug_mesh(tp=tp, dp=1, device=dev) as mesh:
        prefill, _, pspecs = steps.build_prefill_step(
            cfg, mesh, ShapeConfig("gate", S, B, "prefill"), multi_pod=False)
        tok = gather_tree(prefill(*[shard_tree(a, s, mesh) for a, s in zip(
            (params, {"tokens": toks}), pspecs)]), prefill.out_specs, mesh)
        kv = L._dtype(cfg.param_dtype)
        step, args, specs = steps.build_decode_step(
            cfg, mesh, ShapeConfig("gate", S, B, "decode"), multi_pod=False,
            kv_dtype=kv)
        p = shard_tree(params, specs[0], mesh)
        cache = shard_tree(lm.init_cache(cfg, B, S, dtype=kv, device=dev),
                           specs[1], mesh)
        got, ms = [], []
        for t in range(DECODE_STEPS):
            sync(dev)
            t0 = time.perf_counter()
            n, cache = step(p, cache, toks[:, t:t + 1], t)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append(gather_tree(n, step.out_specs[0], mesh))
    if rank:
        return None
    with torch.no_grad():
        x, _ = lm.forward(cfg, params, {"tokens": toks})
        want_tok = L.lm_head_logits(cfg, params["head"], x[:, -1:])[0]
        ucache = lm.init_cache(cfg, B, S, dtype=kv, device=dev)
        want = []
        for t in range(DECODE_STEPS):
            n, ucache = lm.decode_step(cfg, params, ucache, toks[:, t:t + 1],
                                       t)
            want.append(n)
    got, want = torch.cat(got, 1), torch.cat(want, 1)
    return {"mesh": {"data": 1, "model": tp},
            "prefill_tokens_equal": bool(torch.equal(
                tok, want_tok.to(torch.int32))),
            "decode_token_agreement": float((got == want).float().mean()),
            "decode_step_ms": ms}


def rank_main(device, reduced, dtype):
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    n = dist.get_world_size()
    train_cfg, dec_cfg = configs(reduced, dtype)
    B, S = (2, 64) if reduced else (2, 4096)
    meshes = [(1, n)] + ([(2, n // 2)] if n == 4 else [])
    out = {"world": n, "dtype": dtype,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "train": [train_case(train_cfg, dev, dp, tp, B, S)
                     for dp, tp in meshes],
           "decode": decode_case(dec_cfg, dev, n, 4, 64)}
    return out if dist.get_rank() == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every visible card; 4 on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu --reduced to rehearse")
    world = args.world or (torch.cuda.device_count() if args.device == "cuda"
                           else 4)
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()            # once, before the ranks load it
    res = spawn(rank_main, world, args.device, args.reduced, args.dtype,
                device=args.device)
    print(json.dumps(res[0]), flush=True)


if __name__ == "__main__":
    main()
