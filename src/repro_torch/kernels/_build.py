"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, for ``sm_90a``, into ``build/repro_torch/<digest>/`` at
the repository root, where the digest covers every source under ``csrc/``
and the compiler flags. The first call builds whatever is missing (one
``nvcc`` process per source, all started together) and loads it; later
calls, and later processes, reuse it. Nothing here runs at import time.

No ``--use_fast_math``: the quantizer's codes are bit-identical to the
plain version only with IEEE division and rounding.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("quantize", "int8_dist", "pairwise_dist", "kl_similarity",
           "relevance_aggregate", "cluster_dist", "ivf_shortlist",
           "topk_pack", "adaptive_combine", "flash_attention",
           "flash_fwd_sm90", "flash_bwd_sm90", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# seconds from the start of the last build to each source's nvcc exit
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile the sources not yet built, load every library, return them
    by source name. Raises with nvcc's output when a build fails."""
    if len(_libs) == len(SOURCES):
        return _libs
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        so = out / f"lib{name}.so"
        if so.exists():
            continue
        tmp = out / f".lib{name}.{os.getpid()}.so"
        log = out / f".{name}.{os.getpid()}.log"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "wb") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f,
                                            stderr=subprocess.STDOUT),
                           tmp, so, log)
    errors = []
    while procs:                         # each source's exit, as it comes
        for name in [n for n, p in procs.items() if p[0].poll() is not None]:
            proc, tmp, so, log = procs.pop(name)
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode:
                errors.append(f"{name}.cu (exit {proc.returncode}):\n"
                              + log.read_text(errors="replace"))
            else:
                os.replace(tmp, so)  # atomic: no reader sees a half file
            log.unlink()
        time.sleep(0.05)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    for name in SOURCES:
        _libs.setdefault(name, ctypes.CDLL(str(out / f"lib{name}.so")))
    return _libs


def kernel(source: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, typed; every
    entry point returns its ``cudaGetLastError()`` as an int."""
    key = (source, symbol)
    if key not in _fns:
        fn = getattr(build_all()[source], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: Tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype, shape
    and device: the kernels take raw pointers and trust all four."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: on {t.device}; the CUDA kernel takes "
                         "CUDA tensors only")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, other operands on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel needs {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def raise_on_error(what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
