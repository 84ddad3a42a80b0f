"""ReID retrieval serving launcher on the card: device-resident int8 (fp32,
or IVF shortlist) gallery index + continuous query batching. Builds a synthetic fleet,
streams queries through the batcher at peak throughput, lands a mid-stream
federated-round index update, and prints QPS / p50 / p99.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --clients 4 \
      --gallery 8192 --queries 512 --batch 64 --mode int8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode ivf --nprobe 8

Runs on the CUDA device and raises without one; ``--device cpu`` runs the
plain PyTorch versions instead of the kernels.

With ``--trace out.jsonl`` the run executes under a live
``repro_torch.obs`` tracer: serve.batch / serve.index_refresh spans,
bucket-exact latency histograms and rolling QPS from a ``ServeStats``
wired into the batcher (the ``serve.stats`` metric at the end), and IVF
probe metrics when ``--mode ivf``. Inspect the sink with
``python -m repro_torch.obs.report out.jsonl``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import edge_model as EM
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import ServeStats
from repro_torch.serving import ContinuousBatcher, GalleryIndex, RetrievalEngine
from repro_torch.serving.batcher import run_closed_loop


def stacked_heads(cfg, n_clients: int, seed: int, device):
    """``n_clients`` heads from one seeded generator, stacked on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return EM.stack_heads(
        [EM.init_adaptive_layers(cfg, gen) for _ in range(n_clients)], device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--gallery", type=int, default=8192)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--mode", choices=("int8", "fp32", "ivf"), default="int8")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="coarse buckets scored per query (ivf mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="write a repro_torch.obs telemetry JSONL (spans + "
                         "serve stats); read it with python -m "
                         "repro_torch.obs.report")
    args = ap.parse_args(argv)

    tracer = obs.Tracer(path=args.trace) if args.trace else obs.NullTracer()
    try:
        with obs.active(tracer):
            out = _serve(args)
    finally:
        tracer.close()
    if args.trace:
        print(f"telemetry: {args.trace}  "
              f"(python -m repro_torch.obs.report {args.trace})")
    return out


def _serve(args):
    cfg = EM.EdgeModelConfig()
    rng = np.random.default_rng(args.seed)
    C, G = args.clients, args.gallery
    protos = [rng.standard_normal((G, cfg.proto_dim), np.float32)
              for _ in range(C)]
    ids = [np.arange(G, dtype=np.int32) for _ in range(C)]

    t0 = time.perf_counter()
    index = GalleryIndex(protos, ids, keep_fp32=(args.mode == "fp32"),
                         nlist="auto" if args.mode == "ivf" else 0,
                         device=args.device)
    theta = stacked_heads(cfg, C, args.seed, index.device)
    engine = RetrievalEngine(index, theta, k=args.k, mode=args.mode,
                             nprobe=args.nprobe)
    print(f"index: C={C} G={G} mode={args.mode} "
          f"resident={index.resident_bytes(args.mode) / 1e6:.1f} MB "
          f"built in {time.perf_counter() - t0:.2f}s")

    stream = [(int(rng.integers(C)),
               rng.standard_normal(cfg.proto_dim).astype(np.float32), -1)
              for _ in range(args.queries)]

    stats = ServeStats() if obs.is_active() else None
    batcher = ContinuousBatcher(engine, batch=args.batch, stats=stats)
    # warmup launch (kernel load) before measuring
    batcher.submit(0, stream[0][1])
    batcher.drain()

    half = len(stream) // 2
    r1 = run_closed_loop(batcher, stream[:half])
    # a federated round lands mid-stream: new heads, same prototypes —
    # one refresh and the very next batch serves the new index
    tr = time.perf_counter()
    engine.update(stacked_heads(cfg, C, args.seed + 1, index.device))
    if index.device.type == "cuda":
        torch.cuda.synchronize(index.device)
    refresh_ms = (time.perf_counter() - tr) * 1e3
    r2 = run_closed_loop(batcher, stream[half:])

    for tag, r in (("pre-update ", r1), ("post-update", r2)):
        print(f"{tag}: {r['n']} queries  QPS={r['qps']:.0f}  "
              f"p50={r['p50_ms']:.2f}ms  p99={r['p99_ms']:.2f}ms")
    print(f"index update (new adaptive heads, no re-extraction): "
          f"{refresh_ms:.1f} ms")
    if stats is not None:
        obs.metric("serve.stats", stats.snapshot(), mode=args.mode)
    return {"pre": r1, "post": r2, "refresh_ms": refresh_ms}


if __name__ == "__main__":
    main()
