"""The plain reference agrees with the port at each config's ``reduced()``
size on the CPU, in fp32 on both sides: the split step's first three
steps (losses, first gradients, changes) and greedy decode's served
tokens after a filled cache, each driven through the benchmark's own
drivers exactly as a run drives them."""
from __future__ import annotations

import pytest
import torch

from bench import harness
from conftest import small_cell
from repro_torch.configs import get_config

TRAIN = ["qwen3-1.7b.split_train_4k", "qwen1.5-0.5b.split_train_4k"]
DECODE = ["qwen3-1.7b.decode_32k", "qwen1.5-0.5b.decode_32k"]


def reduced_cell(name):
    man, conf, traffic = small_cell(name)
    r = get_config(conf["name"]).reduced()
    conf.update(num_hidden_layers=r.n_layers, hidden_size=r.d_model,
                num_attention_heads=r.n_heads,
                num_key_value_heads=r.n_kv_heads, intermediate_size=r.d_ff,
                vocab_size=r.vocab_size, torch_dtype=r.param_dtype)
    if "head_dim" in conf:
        conf["head_dim"] = r.hd
    return man, conf, traffic


@pytest.fixture(autouse=True)
def _window(steps):
    steps(16)


def _run(name, seed=7):
    man, conf, traffic = reduced_cell(name)
    limits = dict.fromkeys(harness.load_json(
        harness.BENCH / "cells" / f"{name}.json")["limits"], 1.0)
    result, extra = harness.run_cell(man, name, seed, 0.3, False,
                                     torch.device("cpu"), conf=conf,
                                     traffic=traffic, limits=limits)
    numbers = {k: c["value"] for k, c in result["checks"].items()}
    numbers.update(extra["details"]["not_compared"])
    return numbers


@pytest.mark.parametrize("name", TRAIN)
def test_split_step_matches_the_reference_in_fp32(name):
    n = _run(name)
    assert n["loss_gap"] < 1e-6
    assert n["grad_gap"] < 1e-5
    assert n["grad_diff"] < 1e-4
    assert n["change_gap"] < 1e-4


@pytest.mark.parametrize("name", DECODE)
def test_decode_serves_the_references_best_token_in_fp32(name):
    assert _run(name)["token_gap"] < 1e-4


def test_reduced_sizes_are_the_ports():
    _, conf, _ = reduced_cell("qwen3-1.7b.split_train_4k")
    assert conf["hidden_size"] == 256 and conf["torch_dtype"] == "float32"
