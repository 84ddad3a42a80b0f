"""End-to-end training on the PyTorch port: a ~100M-parameter qwen-family
model (the qwen1.5-0.5b architecture cut to ~100M by layer count and
width) trained on structured synthetic tokens with the FedSTIL split
(frozen trunk; the last two blocks and the head adaptive, theta = B ⊙
alpha + A). The counterpart of ``examples/train_e2e.py``.

The loss must drop substantially; prints a CSV learning curve and saves
the trainable (alpha, A) as an npz checkpoint at ``--ckpt``.

Run:  PYTHONPATH=src python examples/train_e2e_torch.py [--steps 300]
      [--batch 8] [--seq 128] [--ckpt build/e2e_qwen100m_torch.npz]
      [--device cpu]        # the card by default
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.common.device import resolve_device, synchronize
from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.train.optimizer import adam, cosine_schedule
from repro_torch.train.trainer import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="build/e2e_qwen100m_torch.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params: qwen1.5-0.5b arch, 8 layers, d=768, vocab 32k
    cfg = dataclasses.replace(
        get_config("qwen1.5-0.5b"),
        name="qwen-100m", n_layers=8, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=2048, vocab_size=32000, head_dim=0,
        param_dtype="float32", compute_dtype="float32", fsdp=False,
        n_adaptive_layers=2)
    print(f"model: {cfg.name}  ~{cfg.n_params()/1e6:.0f}M params "
          f"({cfg.n_layers}L d={cfg.d_model})")

    opt = adam(lr=1e-3, weight_decay=1e-5,
               schedule=cosine_schedule(warmup=20, total=args.steps))
    st = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                          optimizer=opt)
    step = make_train_step(cfg, optimizer=opt, tie_lambda=1e-4)

    rng = np.random.default_rng(0)
    trainable, opt_state = st.trainable, st.opt_state
    t0 = time.time()
    print("step,loss,tokens_per_s")
    losses = []
    for i in range(args.steps):
        toks, labels = synthetic_lm_batch(rng, args.batch, args.seq,
                                          cfg.vocab_size)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        trainable, opt_state, m = step(st.frozen, st.B, trainable, opt_state,
                                       batch)
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            synchronize(dev)
            tps = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"{i},{losses[-1]:.4f},{tps:.0f}", flush=True)

    first, last = losses[0], losses[-1]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'OK: decreased' if last < first - 0.5 else 'WARN'})")
    save_checkpoint(args.ckpt, {"trainable": trainable},
                    metadata={"arch": cfg.name, "steps": args.steps,
                              "final_loss": last})
    print(f"checkpoint -> {args.ckpt}")
    return losses, trainable


if __name__ == "__main__":
    main()
