"""Serving on the PyTorch port: batched greedy decoding through the KV
cache / recurrent-state path for three architecture families, including
the sliding-window ring cache (the long_500k mechanism) and an SSM whose
state is O(1) in the context length. The counterpart of
``examples/serve_decode.py``: its four runs, through
``repro_torch.launch.serve_lm`` in this process.

Run:  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
      # the card by default
"""
import argparse

from repro_torch.launch import serve_lm

RUNS = (
    ["--arch", "qwen1.5-0.5b", "--batch", "2", "--prompt-len", "8",
     "--gen", "24"],
    ["--arch", "qwen1.5-0.5b", "--batch", "2", "--prompt-len", "8",
     "--gen", "24", "--window", "16"],        # ring cache (long-context mode)
    ["--arch", "rwkv6-1.6b", "--batch", "2", "--prompt-len", "8",
     "--gen", "24"],
    ["--arch", "zamba2-2.7b", "--batch", "2", "--prompt-len", "8",
     "--gen", "24"],
)


def main(argv=None):
    """Serve the four runs; returns each run's generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    out = []
    for run in RUNS:
        run = run + ["--device", args.device]
        print("\n$ python -m repro_torch.launch.serve_lm", " ".join(run),
              flush=True)
        out.append(serve_lm.main(run))
    return out


if __name__ == "__main__":
    main()
