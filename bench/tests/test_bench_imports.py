"""What the benchmark may import: nothing under ``bench/`` imports JAX,
jaxlib, flax or the JAX package ``repro`` (each module's top-level name
compared whole: the port ``repro_torch`` begins with ``repro``), nothing
under ``bench/reference/`` imports the port either, and a run leaves none
of them in ``sys.modules``."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port_or_the_harness(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names and "bench" not in names, names


def test_prefix_is_not_the_jax_package():
    # the comparison is by whole top-level name
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_a_small_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [{root!r}, {root!r} + '/src', "
        "{tests!r}]\n"
        "import torch\n"
        "from conftest import small_cell\n"
        "from bench import harness\n"
        "man, conf, tr = small_cell('qwen3-1.7b.decode_32k')\n"
        "res, _ = harness.run_cell(man, 'qwen3-1.7b.decode_32k', 5, 0.2,\n"
        "    False, torch.device('cpu'), conf=conf, traffic=tr)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'repro')))\n").format(
            root=str(ROOT), tests=str(ROOT / "bench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
