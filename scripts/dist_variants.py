#!/usr/bin/env python3
"""Variants of the distance tile (``csrc/dist_tile.cuh``), built side by
side and timed on one card: the design's alternatives and knock-outs that
remove one part of it (a knock-out's outputs are wrong; its times only
show what that part costs).

    python3 scripts/dist_variants.py [NAME ...]     # from the repo root

Each variant is this checkout's ``dist_tile.cuh`` with the text
substitutions of ``VARIANTS``, compiled with nvcc into
``build/dist_variants/<name>/`` and run in a process of its own (two
libraries that hold one kernel symbol cannot launch from one process).
Prints one ``VARIANT`` JSON line each: the tile variant's median device
time (CUDA events, ``chip_smoke.time_ms``) at the serving int8 and fp32
shapes and the round's evaluation shape (``chip_smoke.DIST_PATHS``) and a
digest of its outputs there (equal digests: the same bits). Then one
``PROFILE`` line: for the unmodified tile, each shape's kernel time from
torch.profiler beside the events' time. Needs a CUDA card.
"""
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "dist_variants"

STORE = ("        if (b < B && gi < G)\n"
         "          row[gi] = __fsub_rn(__fadd_rn(qq, n2[j]), "
         "__fmul_rn(2.f, dot));")
# name: [(text, replacement), ...] on dist_tile.cuh
VARIANTS = {
    "tile": [],
    # the stores skipped (the values kept live by a test on NaN)
    "no_stores": [(STORE, STORE.replace(
        "if (b < B && gi < G)\n          row[gi] = ",
        "const float r_ = ").replace(
        "dot));", "dot));\n        if (b < B && gi < G && r_ != r_) "
        "row[gi] = r_;"))],
    # each stage's operands read once instead of per float4 of k
    "no_operand_loads": [
        ("a[i] = qs[slot(ty + 8 * i, kq)];", "a[i] = qs[slot(ty + 8 * i, 0)];"),
        ("v[j] = gs[slot(tx + kTX * j, kq)];",
         "v[j] = gs[slot(tx + kTX * j, 0)];")],
    # the epilogue run once, after the block's last tile
    "no_epilogue": [("    if (kt != nk - 1) continue;",
                     "    if (kt != nk - 1 || st + 1 < steps) continue;")],
    # no epilogue but the last, no waits or barriers, no copies but the first
    "bare": [
        ("    if (kt != nk - 1) continue;",
         "    if (kt != nk - 1 || st + 1 < steps) continue;"),
        ('    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'
         "    __syncthreads();          // stage st landed; stage st - 1 is"
         " free", ""),
        ("    if (st + 1 < steps) {", "    if (st + 1 < steps && steps < 0) {")],
    # four times the FMAs of every stage
    "fma_x4": [("    product(qs, gs, ty, tx, acc);\n",
                "    for (int rep_ = 0; rep_ < 4; ++rep_) "
                "product(qs, gs, ty, tx, acc);\n")],
    # 64 features a stage: one step a tile at F = 64
    "stage_64": [("constexpr int kVK = 32;", "constexpr int kVK = 64;")],
    # the epilogue as one FMA (the same bits: 2 x is exact)
    "epilogue_fma": [(
        "row[gi] = __fsub_rn(__fadd_rn(qq, n2[j]), __fmul_rn(2.f, dot));",
        "row[gi] = __fmaf_rn(-2.f, dot, __fadd_rn(qq, n2[j]));")],
    # the product's k loop fully unrolled
    "unroll_full": [("#pragma unroll 2\n  for (int kq", "#pragma unroll\n"
                     "  for (int kq")],
}
SOURCES = ("pairwise_dist", "int8_dist")


def build(name):
    """Write the variant's sources and start its two nvcc builds."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    text = (CSRC / "dist_tile.cuh").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            sys.exit(f"{name}: {old!r} is not in dist_tile.cuh")
        text = text.replace(old, new)
    (d / "dist_tile.cuh").write_text(text)
    procs = []
    for src in SOURCES:
        (d / f"{src}.cu").write_text((CSRC / f"{src}.cu").read_text())
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(d / f"lib{src}.so"), str(d / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def digest(x):
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def entries(name):
    """The variant's two entry points as (q, g, ...) -> out on the card."""
    import torch
    V, I = ctypes.c_void_p, ctypes.c_int
    d = OUT / name
    fp = ctypes.CDLL(str(d / "libpairwise_dist.so")).repro_batched_pairwise_dist
    fp.argtypes, fp.restype = [V] * 3 + [I] * 5 + [V], I
    i8 = ctypes.CDLL(
        str(d / "libint8_dist.so")).repro_batched_int8_pairwise_dist
    i8.argtypes, i8.restype = [V] * 5 + [I] * 5 + [V], I

    def run(fn, q, *gal):
        C, B, F = q.shape
        G = gal[0].shape[1]
        out = torch.empty((C, B, G), device=q.device)
        rc = fn(q.data_ptr(), *(t.data_ptr() for t in gal), out.data_ptr(),
                C, B, G, F, 0, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: launch failed with error {rc}")
        return out
    return (lambda q, g: run(fp, q, g),
            lambda q, gq, gs, gn2: run(i8, q, gq, gs, gn2))


def measure(name):
    """One process: the variant at the three path shapes."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    dev = torch.device("cuda", 0)
    fp, i8 = entries(name)
    row = {"variant": name}
    for path in ("serve_int8", "serve_fp32", "round_eval"):
        gen = torch.Generator(device=dev).manual_seed(CS.SEED)
        kind = ("batched_int8_pairwise_dist" if path == "serve_int8"
                else "batched_pairwise_dist")
        args = CS.dist_operands(kind, gen, dev, *CS.DIST_PATHS[path])
        fn = i8 if path == "serve_int8" else fp
        row[f"{path}_sha"] = digest(fn(*args))
        row[f"{path}_ms"] = CS.time_ms(lambda: fn(*args))
    print("VARIANT", json.dumps(row), flush=True)


def profile():
    """The unmodified tile through its wrappers: each path shape's kernel
    time from torch.profiler (median of 10 launches) beside CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    dev = torch.device("cuda", 0)
    row = {}
    for path in ("serve_int8", "serve_fp32", "round_eval"):
        gen = torch.Generator(device=dev).manual_seed(CS.SEED)
        kind = ("batched_int8_pairwise_dist" if path == "serve_int8"
                else "batched_pairwise_dist")
        args = CS.dist_operands(kind, gen, dev, *CS.DIST_PATHS[path])
        fn = CS.KERNELS[kind]["fn"]
        events_ms = CS.time_ms(lambda: fn(*args))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
        us = sorted(e.device_time for e in p.events()
                    if e.device_type == DeviceType.CUDA
                    and "dist_tile_kernel" in e.name)
        row[path] = {"events_ms": events_ms, "launches": len(us),
                     "kernel_ms": us[len(us) // 2] / 1e3 if us else None}
    print("PROFILE", json.dumps(row), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        return measure(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "--profile":
        return profile()
    names = sys.argv[1:] or list(VARIANTS)
    bad = [n for n in names if n not in VARIANTS]
    if bad:
        sys.exit(f"unknown variants {bad}: choose from {list(VARIANTS)}")
    builds = {n: build(n) for n in names}
    for n, procs in builds.items():
        for p in procs:
            log = p.communicate()[0]
            if p.returncode:
                sys.exit(f"{n}: nvcc failed:\n{log}")
    for n in names:
        subprocess.run([sys.executable, __file__, "--measure", n],
                       check=True, timeout=600)
    subprocess.run([sys.executable, __file__, "--profile"], check=True,
                   timeout=600)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
