"""``bench/run.py`` on a host without a CUDA card exits with a code other
than 0 and prints no result: a run never falls back to the CPU."""
from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks a host without one")


@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_without_a_card_fails_and_prints_nothing(no_card, trace):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "qwen1.5-0.5b.decode_32k", "--seed", str(2 ** 31 + 11),
         "--seconds", "1", "--trace", trace],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_in_a_tree_of_the_benchmark_alone_fails(tmp_path):
    """A directory holding only BENCHMARK.json and ``bench/``: the system
    under test is missing, and the run exits non-zero with no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "qwen3-1.7b.split_train_4k", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
