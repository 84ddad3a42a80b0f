#!/usr/bin/env python3
"""Both aggregate kernels of one checkout, timed and fingerprinted, for an
A/B between two checkouts on one card.

    python3 scripts/aggregate_ab.py TREE LABEL     # from the repo root

Runs this checkout's ``chip_smoke.py`` against TREE's ``src/`` (TREE
``.`` for this checkout; for another one the script is copied into TREE
as ``chip_smoke_ab.py`` and imported from there): builds TREE's kernels,
times both entries at ``AGG_FUSED_TIMED`` / ``AGG_PLAIN_TIMED`` beside
``torch.mm`` (``aggregate_timings``), and prints sha256 digests of B and
Wn on seeded inputs at shapes of every variant (skinny, tiled, ragged),
so two trees' outputs compare bit for bit. Run parent, change, change,
parent in one call on one card (e.g. the parent unpacked with ``git
archive`` into a gitignored directory). Needs a CUDA card.
"""
import hashlib
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main():
    tree, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    if tree != HERE:
        shutil.copy(HERE / "chip_smoke.py", tree / "chip_smoke_ab.py")
        sys.path.insert(0, str(tree))
        import chip_smoke_ab as CS
    else:
        sys.path.insert(0, str(tree))
        import chip_smoke as CS
    import torch
    if not hasattr(CS.RA, "_plan"):          # a tree before the variants
        CS.RA._plan = lambda *a, **k: type("P", (), {"variant": "one"})()
    dev = torch.device("cuda", 0)
    CS._build.build_all()
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    peak = CS.peaks(torch.cuda.get_device_name(0))
    print("TIMES", json.dumps({
        "label": label, "fused": CS.aggregate_timings(gen, dev, peak, True),
        "plain": CS.aggregate_timings(gen, dev, peak, False)}), flush=True)

    def digest(x):
        return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]

    gen = torch.Generator(device=dev).manual_seed(123)
    out = {}
    for c, p in ((5, 37696), (5, 57664), (33, 1000), (100, 57664),
                 (1000, 57664), (7, 1001), (129, 333)):
        w = torch.rand((c, c), generator=gen, device=dev)
        w.fill_diagonal_(7.5)
        w[1] = 0.0
        th = 10.0 * torch.randn((c, p), generator=gen, device=dev)
        b, wn = CS.fused_relevance_aggregate(w, th)
        out[f"fused {c}x{p}"] = [digest(b), digest(wn)]
        rows = wn[:max(1, c // 2)].contiguous()
        out[f"plain {rows.shape[0]}x{c}x{p}"] = digest(
            CS.relevance_aggregate(rows, th))
    print("DIGESTS", label, json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
