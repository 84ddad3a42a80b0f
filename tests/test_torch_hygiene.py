"""Structural rules of the PyTorch port, checked on its sources:

  * src/repro_torch/, chip_smoke.py and the port's examples
    (``examples/*_torch.py``) import neither jax / jaxlib nor the JAX
    package ``repro`` (the port keeps its own copies);
  * every CUDA kernel wrapper carries an integer ``launches`` counter, and
    its kernel module names the TPU kernel it replaces (the four flash
    attention stages among them); the two forwards also count their
    the four flash stages also count their tensor-core launches, and each
    tensor-core source names the TPU kernels it replaces;
  * no CUDA source asks for fast math (the quantizer's bit-exactness and
    the IEEE fp32 sums depend on it).
"""
import ast
import importlib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
WRAPPERS = [("quantize", "batched_quantize"),
            ("int8_dist", "batched_int8_pairwise_dist"),
            ("pairwise_dist", "batched_pairwise_dist"),
            ("kl_similarity", "kl_similarity"),
            ("relevance_aggregate", "fused_relevance_aggregate"),
            ("relevance_aggregate", "normalize_relevance"),
            ("ivf", "batched_cluster_dist"),
            ("ivf", "batched_ivf_shortlist_scores"),
            ("topk_pack", "batched_topk_pack"),
            ("topk_pack", "batched_topk_unpack"),
            ("topk_pack", "batched_idx_bitpack"),
            ("topk_pack", "batched_idx_bitunpack"),
            ("topk_pack", "batched_topk_decode_int8"),
            ("quantize", "batched_dequantize"),
            ("relevance_aggregate", "relevance_aggregate"),
            ("adaptive_combine", "adaptive_combine"),
            ("adaptive_combine", "adaptive_combine_tree"),
            ("pairwise_dist", "pairwise_dist"),
            ("flash_attention", "flash_attention_fwd"),
            ("flash_attention", "flash_attention_fwd_lse"),
            ("flash_attention", "flash_attention_dq"),
            ("flash_attention", "flash_attention_dkv")]
# wrappers whose CUDA source is not named after their module
SOURCE_OF = {("ivf", "batched_cluster_dist"): "cluster_dist",
             ("ivf", "batched_ivf_shortlist_scores"): "ivf_shortlist"}
# wrappers whose TPU kernel is not ``<module>.py:<wrapper name>``
REPLACES = {
    ("relevance_aggregate", "normalize_relevance"):
        "src/repro/kernels/relevance_aggregate.py:fused_relevance_aggregate",
    ("topk_pack", "batched_topk_decode_int8"):
        "src/repro/kernels/quantize.py:batched_dequantize",
    ("flash_attention", "flash_attention_fwd"):
        "src/repro/kernels/flash_attention.py:flash_attention",
    ("flash_attention", "flash_attention_fwd_lse"):
        "src/repro/kernels/flash_attention_bwd.py:_fwd",
    ("flash_attention", "flash_attention_dq"):
        "src/repro/kernels/flash_attention_bwd.py:_dq_kernel",
    ("flash_attention", "flash_attention_dkv"):
        "src/repro/kernels/flash_attention_bwd.py:_dkv_kernel"}
# the bf16 tensor-core sources, each with the TPU kernels it replaces,
# and each flash stage's (source, C entry point) in bf16
TC_SOURCES = {
    "flash_fwd_sm90": ("src/repro/kernels/flash_attention.py:flash_attention",
                       "src/repro/kernels/flash_attention_bwd.py:_fwd"),
    "flash_bwd_sm90": ("src/repro/kernels/flash_attention_bwd.py:_dq_kernel",
                       "src/repro/kernels/flash_attention_bwd.py:_dkv_kernel")}
TC_KERNEL = {"flash_attention_fwd": ("flash_fwd_sm90", "repro_flash_fwd_sm90"),
             "flash_attention_fwd_lse": ("flash_fwd_sm90",
                                         "repro_flash_fwd_sm90"),
             "flash_attention_dq": ("flash_bwd_sm90", "repro_flash_dq_sm90"),
             "flash_attention_dkv": ("flash_bwd_sm90",
                                     "repro_flash_dkv_sm90")}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module,name", WRAPPERS)
def test_kernel_wrappers_count_launches(module, name):
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    wrapper = getattr(mod, name)
    assert isinstance(wrapper.launches, int)
    source = SOURCE_OF.get((module, name), module)
    src = (PORT / "kernels" / "csrc" / f"{source}.cu").read_text()
    assert REPLACES.get((module, name),
                        f"src/repro/kernels/{module}.py:{name}") in src
    assert "extern \"C\" int repro_" in src


def test_no_fast_math_in_kernel_builds():
    flags = importlib.import_module("repro_torch.kernels._build").NVCC_FLAGS
    assert not any("fast_math" in f or "ftz" in f or "prec-div" in f
                   for f in flags)
    assert "arch=compute_90a,code=sm_90a" in flags


@pytest.mark.parametrize("name", ["flash_attention_fwd",
                                  "flash_attention_fwd_lse",
                                  "flash_attention_dq",
                                  "flash_attention_dkv"])
def test_tensor_core_forwards_count_launches_and_name_their_kernels(name):
    build = importlib.import_module("repro_torch.kernels._build")
    wrapper = getattr(importlib.import_module(
        "repro_torch.kernels.flash_attention"), name)
    assert isinstance(wrapper.launches, int)
    assert isinstance(wrapper.tc_launches, int)
    source, symbol = TC_KERNEL[name]
    assert source in build.SOURCES
    src = (PORT / "kernels" / "csrc" / f"{source}.cu").read_text()
    assert all(r in src for r in TC_SOURCES[source])
    assert f"extern \"C\" int {symbol}(" in src
    assert '#include "sm90_common.cuh"' in src
    shared = (PORT / "kernels" / "csrc" / "sm90_common.cuh").read_text()
    assert not any(f"{fast}(" in text for text in (src, shared) for fast in
                   ("__expf", "__exp10f", "__logf", "__fdividef"))
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)


@pytest.mark.parametrize("source", ["kl_similarity", "quantize"])
def test_fp32_kernel_sources_use_no_fast_intrinsics(source):
    """The KL similarity's expf / logf / __fdiv_rn and the quantizer's
    division are IEEE: bit-identical outputs rest on them, so neither
    source calls the approximate intrinsics."""
    src = (PORT / "kernels" / "csrc" / f"{source}.cu").read_text()
    assert not any(f"{fast}(" in src for fast in
                   ("__expf", "__exp10f", "__logf", "__fdividef"))
    assert "__fdiv_rn(" in src


DIST_SOURCES = ("dist_tile.cuh", "pairwise_dist.cu", "int8_dist.cu",
                "cluster_dist.cu")


@pytest.mark.parametrize("source", DIST_SOURCES)
def test_distance_sources_stay_ieee_fp32_fma(source):
    """The distance tile's outputs are bit-identical between its variants
    and to the parent kernel only in IEEE fp32 FFMA: no approximate
    intrinsics, no tensor-core product (mma, wgmma, TF32), and each entry
    point takes the variant _plan picked."""
    src = (PORT / "kernels" / "csrc" / source).read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert not any(f"{fast}(" in code for fast in
                   ("__expf", "__exp10f", "__logf", "__fdividef", "__fmaf_",
                    "__fmul_rz", "__fadd_rz"))
    assert not any(op in code for op in ("mma", "tf32", "wmma", "sm90_common"))
    if source == "dist_tile.cuh":
        assert "fmaf(" in code and "__fsub_rn(" in code
        assert "cp.async.cg.shared.global" in code
    else:
        assert '#include "dist_tile.cuh"' in code
        assert "int variant" in code
        assert re.search(r"variant,\s*\(cudaStream_t\)stream", code)


DIST_WRAPPERS = {"pairwise_dist": ("batched_pairwise_dist", "pairwise_dist"),
                 "int8_dist": ("batched_int8_pairwise_dist",),
                 "ivf": ("batched_cluster_dist",
                         "batched_ivf_shortlist_scores")}


@pytest.mark.parametrize("module", sorted(DIST_WRAPPERS))
def test_distance_wrappers_alone_count_their_launches(module):
    """Only the public wrappers add to ``launches``: the launchers that take
    a plan (``_batched``, ``_pairwise``, ``_launch``, ``_cluster``), which
    chip_smoke.py calls with a forced variant to hold it against the plain
    version, never count. Every distance wrapper hands its launcher the
    plan of ``pairwise_dist._plan``."""
    path = PORT / "kernels" / f"{module}.py"
    tree = ast.parse(path.read_text())
    counting = set()
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        for node in ast.walk(fn):
            if (isinstance(node, ast.AugAssign)
                    and isinstance(node.target, ast.Attribute)
                    and node.target.attr == "launches"):
                counting.add(fn.name)
    assert counting == set(DIST_WRAPPERS[module])
    src = path.read_text()
    assert "VARIANTS.index(plan.variant)" in src
    assert "_plan(" in src
