"""Training launcher for the LMs (any registered arch): the port of
``repro/launch/train.py`` (its flags, plus ``--device``).

Runs real steps of the FedSTIL split step (frozen trunk; the adaptive last
block + head as theta = B * alpha + A, ``tie_lambda`` 1e-4) or, with
``--full``, of full fine-tuning. Reduced configs by default; ``--full-model``
trains the configuration at its published width. On the card unless
``--device cpu`` (the plain versions, for small shapes).

``--trace out.jsonl`` runs the steps under a live ``repro_torch.obs``
tracer: each split step's ``train.step`` span and the phases that tile it
(combine, trunk, adaptive, head, the two halves of the backward, clip,
Adam), with device time on the card; read it with
``python -m repro_torch.obs.report out.jsonl``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 100 --batch 8 --seq 64 [--full-model] [--full] [--device cpu] \\
      [--trace out.jsonl]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.common.device import resolve_device, synchronize
from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.models import lm
from repro_torch.obs import trace as obs
from repro_torch.train.optimizer import adam, cosine_schedule
from repro_torch.train.trainer import (init_opt_state, init_train_state,
                                       make_full_train_step, make_train_step)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-model", dest="reduced", action="store_false")
    ap.add_argument("--full", action="store_true",
                    help="train ALL params (beyond-paper), not just adaptive")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="write a repro_torch.obs telemetry JSONL (a span "
                         "per step and per phase); read it with python -m "
                         "repro_torch.obs.report")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns the per-step losses (host floats)."""
    args = parse_args(argv)
    tracer = obs.Tracer(path=args.trace) if args.trace else obs.NullTracer()
    try:
        with obs.active(tracer):
            losses = _train(args)
    finally:
        tracer.close()
    if args.trace:
        print(f"telemetry: {args.trace}  "
              f"(python -m repro_torch.obs.report {args.trace})")
    return losses


def _train(args):
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt = adam(lr=args.lr, weight_decay=1e-5,
               schedule=cosine_schedule(warmup=20, total=args.steps))
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    if args.full:
        params = lm.init_params(cfg, gen)
        opt_state = init_opt_state(opt, params)
        step = make_full_train_step(cfg, optimizer=opt)
    else:
        st = init_train_state(cfg, gen, optimizer=opt)
        trainable, opt_state = st.trainable, st.opt_state
        step = make_train_step(cfg, optimizer=opt, tie_lambda=1e-4)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        toks, labels = synthetic_lm_batch(rng, args.batch, args.seq,
                                          cfg.vocab_size)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        if args.full:
            params, opt_state, m = step(params, opt_state, batch)
        else:
            trainable, opt_state, m = step(st.frozen, st.B, trainable,
                                           opt_state, batch)
        losses.append(float(m["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            synchronize(dev)
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"ce {float(m['ce']):.4f}  {time.time()-t0:.1f}s",
                  flush=True)

    if args.ckpt:
        tree = params if args.full else {"trainable": trainable, "B": st.B}
        save_checkpoint(args.ckpt, tree, metadata={"arch": args.arch,
                                                   "steps": args.steps})
        print(f"checkpoint -> {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
