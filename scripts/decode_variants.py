#!/usr/bin/env python3
"""Variants of the int8 decode's prologue (``csrc/topk_pack.cu``:
``dequant_in``, ``prefetch_int8``), built side by side and timed on one
card: the design's alternatives, all with the same outputs.

    python3 scripts/decode_variants.py [NAME ...]    # from the repo root

Each variant is this checkout's ``topk_pack.cu`` with the text
substitutions of ``VARIANTS``, compiled with nvcc into
``build/decode_variants/<name>/`` and run in a process of its own (two
libraries that hold one kernel symbol cannot launch from one process), in
the order a b c ... c b a. Prints one ``VARIANT`` JSON line a run: the
registers of ``topk_decode_kernel<8>`` (``cuobjdump -res-usage``), the
median device time (CUDA events, ``chip_smoke.time_ms``) of the int8
decode at the round's (5, 37696) and the fleet's (1000, 57664) payloads
(chunk 256, kg 3 of 8) and of the fp32 decode, which shares the kernel, on
the same payloads dequantized, with a digest of the int8 decode's outputs
(equal digests: the same bits); the first run also times a ``fill_`` of
the fleet's (1000, 57664) fp32 output, the write-only floor. Inputs come
from the plain versions, so no other library is loaded. Needs a CUDA card.
"""
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "decode_variants"

PREFETCH_CALL = ("  if (codes) prefetch_int8(codes + first, sc, g0 * kg, "
                 "chunk, n);\n")
SCALE_PREFETCH = ("  if (threadIdx.x < 2)\n"
                  '    asm volatile("prefetch.global.L1 [%0];\\n" ::"l"(\n'
                  "        sc + (j0 + threadIdx.x * (n - 1)) / chunk));\n")
RELOAD = """    unsigned ci = (j0 + i) / chunk;
    unsigned r = j0 + i - ci * chunk;
    float s = sc[ci];
    float f[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (r == chunk) {
        r = 0;
        s = sc[++ci];
      }
      ++r;
      const float code = (float)(int8_t)(words[e >> 2] >> (8 * (e & 3)));
      f[e] = __fmul_rn(code, s);
    }
"""
PAIRED = """    const unsigned ci = (j0 + i) / chunk;
    const unsigned r = j0 + i - ci * chunk;
    const float s0 = sc[ci];
    const float s1 = chunk >= 16 && r + 16 > chunk ? sc[ci + 1] : 0.f;
    float f[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float code = (float)(int8_t)(words[e >> 2] >> (8 * (e & 3)));
      const float s = chunk >= 16 ? (r + e < chunk ? s0 : s1)
                                  : sc[(j0 + i + e) / chunk];
      f[e] = __fmul_rn(code, s);
    }
"""
# the codes staged by 16-byte cp.async into shared bytes before the plane
# bytes load (each thread converts the vectors it copied, after its wait)
CP_ASYNC = [
    ("  for (unsigned i = 128 * threadIdx.x; i < n + 127; "
     "i += 128 * kThreads)\n"
     '    asm volatile("prefetch.global.L1 [%0];\\n" ::"l"(q + min(i, n - 1)));'
     "\n",
     "  const unsigned head =\n"
     "      min(n, (unsigned)((16u - ((uintptr_t)q & 15u)) & 15u));\n"
     "  for (unsigned v = threadIdx.x; v < (n - head) >> 4; v += kThreads)\n"
     '    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(\n'
     "                     smem_addr(sq + 16 * v)), \"l\"(q + head + 16 * v)"
     "\n                 : \"memory\");\n"
     '  asm volatile("cp.async.commit_group;\\n" ::: "memory");\n'),
    ("__device__ __forceinline__ void prefetch_int8(const int8_t* q,",
     "__device__ __forceinline__ void prefetch_int8(uint8_t* sq, "
     "const int8_t* q,"),
    ("__device__ __noinline__ unsigned dequant_in(float* __restrict__ sm,\n",
     "__device__ __noinline__ unsigned dequant_in(float* __restrict__ sm,\n"
     "                                            const uint8_t* sq,\n"),
    ("                                            unsigned n) {\n"
     "  const unsigned off = (unsigned)(uintptr_t)q & 3u;\n",
     "                                            unsigned n) {\n"
     '  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'
     "  const unsigned off = (unsigned)(uintptr_t)q & 3u;\n"),
    ("    const uint4 w = *reinterpret_cast<const uint4*>(q + i);",
     "    const uint4 w = *reinterpret_cast<const uint4*>(sq + 16 * v);"),
    ("  __shared__ uint8_t sp[kBits * kPlane];\n",
     "  __shared__ uint8_t sp[kBits * kPlane];\n"
     "  __shared__ __align__(16) uint8_t sq[kMaxPer * kThreads * G];\n"),
    (PREFETCH_CALL,
     "  if (codes) prefetch_int8(sq, codes + first, sc, g0 * kg, chunk, n);"
     "\n"),
    ("codes ? dequant_in(sv, codes + first",
     "codes ? dequant_in(sv, sq, codes + first")]
# name: [(text, replacement), ...] on topk_pack.cu
VARIANTS = {
    "lines": [],                                   # as committed
    "code_lines": [(SCALE_PREFETCH, "")],          # no scale-line prefetch
    "none": [(PREFETCH_CALL, "")],                 # no prefetch
    "paired_scales": [(RELOAD, PAIRED)],           # both scales loaded early
    "cp_async_codes": CP_ASYNC,
}
SHAPES = ((5, 37696), (1000, 57664))
GROUP, KG, CHUNK = 8, 3, 256


def build(name):
    """Write the variant's source and start its nvcc build."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    text = (CSRC / "topk_pack.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            sys.exit(f"{name}: {old!r} is not in topk_pack.cu")
        text = text.replace(old, new)
    (d / "topk_pack.cu").write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "libtopk_pack.so"),
         str(d / "topk_pack.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def registers(name):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    usage = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-res-usage",
         str(OUT / name / "libtopk_pack.so")], capture_output=True,
        text=True, check=True).stdout
    return int(re.search(r"topk_decode_kernelILi8E\S*\s*REG:(\d+)",
                         usage).group(1))


def measure(name, floor):
    """One process: the variant's two decodes at ``SHAPES``."""
    import torch
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    from repro_torch.kernels import ref as REF
    V, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = ctypes.CDLL(str(OUT / name / "libtopk_pack.so"))
    dec8, dec = lib.repro_batched_topk_decode_int8, lib.repro_batched_topk_decode
    dec8.argtypes, dec8.restype = [V] * 4 + [L] * 4 + [I] * 5 + [V], I
    dec.argtypes, dec.restype = [V] * 3 + [L] * 3 + [I] * 4 + [V], I
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    row = {"variant": name, "registers": registers(name)}
    for c, p in SHAPES:
        x = CS.codec_rows(gen, dev, c, p)
        vals, planes = REF.batched_topk_encode_ref(x, group=GROUP, kg=KG)
        q, sc = REF.batched_quantize_ref(vals, chunk=CHUNK)
        deq = REF.batched_dequantize_ref(q, sc, chunk=CHUNK).contiguous()
        out = torch.empty((c, p), device=dev)
        kb = planes.shape[1] // 3
        per = CS.TP._plan(c, p, GROUP, KG, True).per
        st = torch.cuda.current_stream().cuda_stream

        def run8():
            rc = dec8(q.data_ptr(), sc.data_ptr(), planes.data_ptr(),
                      out.data_ptr(), c, p, kb, sc.shape[1], CHUNK, GROUP, KG,
                      1, per, st)
            if rc:
                raise RuntimeError(f"{name}: launch failed with error {rc}")

        def run32():
            rc = dec(deq.data_ptr(), planes.data_ptr(), out.data_ptr(), c, p,
                     kb, GROUP, KG, 1, per, st)
            if rc:
                raise RuntimeError(f"{name}: launch failed with error {rc}")
        run8()
        torch.cuda.synchronize()
        row[f"int8_{c}_sha"] = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()[:16]
        row[f"int8_{c}_ms"] = CS.time_ms(run8)
        row[f"fp32_{c}_ms"] = CS.time_ms(run32)
        if floor and c == SHAPES[-1][0]:
            row["fill_ms"] = CS.time_ms(lambda: out.fill_(0.5))
    print("VARIANT", json.dumps(row), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--measure":
        measure(sys.argv[2], sys.argv[3:] == ["--floor"])
        return
    names = sys.argv[1:] or list(VARIANTS)
    bad = [n for n in names if n not in VARIANTS]
    if bad:
        sys.exit(f"unknown variants {bad}: choose from {list(VARIANTS)}")
    for name, proc in [(n, build(n)) for n in names]:
        if proc.wait():
            sys.exit(f"{name}: nvcc failed\n{proc.stdout.read()}")
    for i, name in enumerate(names + names[::-1]):
        subprocess.run([sys.executable, __file__, "--measure", name]
                       + (["--floor"] if i == 0 else []), check=True)


if __name__ == "__main__":
    main()
