"""LM decode serving launcher: batched greedy decoding through the KV cache
or the recurrent state, the port of ``repro/launch/serve_lm.py`` (its
flags, plus ``--device`` and ``--full-model``). The ReID retrieval
service is ``repro_torch.launch.serve``.

The prompt is fed token by token through ``decode_step`` (no prefill
pass), then ``--gen`` tokens are generated greedily. ``--window N``
serves from a ring cache of N slots (the long-context mode); otherwise
the cache holds every position. Reduced configs by default (fp32 weights
and cache, as the reference); ``--full-model`` serves the configuration
at its published width, in its bf16. On the card unless ``--device cpu``
(the plain versions, for small shapes).

``--trace out.jsonl`` serves under a live ``repro_torch.obs`` tracer: a
dense model's ``decode.step`` spans and the phases that tile them (per
layer the qkv projection and cache write, the cache read, the attention,
the output projection and MLP; then the head), with device time on the
card; read it with ``python -m repro_torch.obs.report out.jsonl``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch rwkv6-1.6b \\
      --batch 4 --prompt-len 16 --gen 32 [--window 16] [--full-model] \\
      [--device cpu] [--trace out.jsonl]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device, synchronize
from repro_torch.common.pytree import device_of
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.layers import _dtype
from repro_torch.obs import trace as obs


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: sliding-window ring cache (long-context mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-model", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="write a repro_torch.obs telemetry JSONL (a span "
                         "per step and per phase); read it with python -m "
                         "repro_torch.obs.report")
    return ap.parse_args(argv)


def serve(cfg, params, prompt, gen: int, *, window: int = 0, device=None):
    """The launcher's loop: prompt (B, P) ids fed token by token, then
    ``gen`` greedy tokens, one ``decode_step`` each on one cache in the
    params' dtype (a ring of ``window`` slots when ``window > 0``), on
    ``device`` (the params' device by default). Returns (generated (B,
    gen) int32 numpy, the cache)."""
    if device is None:
        device = device_of(params)
    B, P = prompt.shape
    total = P + gen
    cache = lm.init_cache(cfg, B, window or total, enc_seq=cfg.enc_seq,
                          dtype=_dtype(cfg.param_dtype), device=device)
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    tok, generated = prompt[:, :1], []
    for pos in range(total - 1):
        fed = prompt[:, pos:pos + 1] if pos < P - 1 else tok
        nxt, cache = lm.decode_step(cfg, params, cache, fed, pos,
                                    window=window, ring=bool(window),
                                    enc_len=cfg.enc_seq or None)
        if pos >= P - 1:
            generated.append(nxt)
            tok = nxt
    return torch.cat(generated, 1).cpu().numpy(), cache


def main(argv=None):
    """Serve once; returns the generated tokens (B, gen) as numpy."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))

    tracer = obs.Tracer(path=args.trace) if args.trace else obs.NullTracer()
    synchronize(dev)
    t0 = time.time()
    try:
        with obs.active(tracer):
            gen, _ = serve(cfg, params, prompt, args.gen,
                           window=args.window, device=dev)
            synchronize(dev)
            wall = time.time() - t0
    finally:
        tracer.close()
    print(f"arch={cfg.name} batch={args.batch} generated={gen.shape[1]} "
          f"tokens window={args.window or 'full'}")
    print(f"throughput: {args.batch * gen.shape[1] / wall:.1f} tok/s "
          f"({dev.type}, {'reduced' if args.reduced else 'full'} config)")
    print("sample:", gen[0][:16].tolist())
    if args.trace:
        print(f"telemetry: {args.trace}  "
              f"(python -m repro_torch.obs.report {args.trace})")
    return gen


if __name__ == "__main__":
    main()
