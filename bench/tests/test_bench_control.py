"""The control comes out not correct: the reference computed in fp8 (e4m3
operands, e5m2 gradients, per-tensor scales), the next precision below
the bf16 the configs state, put in the program's place and judged against
the fp32 reference under the cell's own limits, at a size the CPU holds.
The same readings on the card, at the cells' own sizes, come from
``bench/control.py``."""
from __future__ import annotations

import pytest
import torch

from bench import harness
from conftest import small_cell

CELLS = ["qwen3-1.7b.split_train_4k", "qwen1.5-0.5b.split_train_4k",
         "qwen3-1.7b.decode_32k", "qwen1.5-0.5b.decode_32k"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_control_fails_a_limit(name, seed, steps):
    steps(96)
    deep = {"num_hidden_layers": 8, "hidden_size": 256,
            "intermediate_size": 512} if "decode" in name else {}
    man, conf, traffic = small_cell(name, **deep)
    result, extra = harness.run_cell(man, name, seed, 2.0, False,
                                     torch.device("cpu"), conf=conf,
                                     traffic=traffic, controls=True)
    limits = {k: c["limit"] for k, c in result["checks"].items()}
    fp8 = extra["controls"]["fp8"]
    assert any(fp8[k] > limits[k] for k in limits), (fp8, limits)
    assert result["correct"], result["checks"]
