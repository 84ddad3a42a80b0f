"""The benchmark's copies of the operation and byte arithmetic: the split
step's and decode's FLOPs equal the port's first-principles model
(``repro_torch.sharding.analytic``, unsharded) at the cells' shapes, and
decode's bytes equal the weights plus the valid cache positions worked
out by hand."""
from __future__ import annotations

import json

import pytest

from bench import arith, harness, inputs
from bench.reference.dense_lm import Arch
from conftest import ROOT
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.sharding.analytic import analytic_roofline

MAN = harness.manifest()


def _cells(kind):
    for w in MAN["workloads"]:
        traffic = harness.load_json(harness.BENCH / "traffic" /
                                    f"{w['traffic']}.json")
        if traffic["kind"] == kind:
            conf = json.loads((ROOT / harness.config_entry(
                MAN, w["config"])["file"]).read_text())
            yield pytest.param(conf, traffic, id=w["name"])


def _analytic(name, seq, batch, mode):
    return analytic_roofline(get_config(name), ShapeConfig("cell", seq, batch,
                                                           mode),
                             tp=1, dp=1)["flops_per_device"]


@pytest.mark.parametrize("conf,traffic", list(_cells("train")))
def test_train_step_flops_equal_the_ports_model(conf, traffic):
    a = Arch(conf)
    want = _analytic(conf["name"], traffic["seq"], traffic["batch"], "train")
    got = arith.train_step_flops(a, traffic["batch"], traffic["seq"])
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("conf,traffic", list(_cells("decode")))
@pytest.mark.parametrize("where", ["first", "last"])
def test_decode_step_flops_equal_the_ports_model(conf, traffic, where):
    a = Arch(conf)
    valid = traffic["prompt"] + 1 if where == "first" else traffic["slots"]
    want = _analytic(conf["name"], valid, traffic["batch"], "decode")
    got = arith.decode_step_flops(a, traffic["batch"], valid)
    assert got == pytest.approx(want, rel=1e-12)


def test_decode_bytes_by_hand_for_a_small_shape():
    conf = json.loads((ROOT / "bench/configs/qwen1.5-0.5b.json").read_text())
    conf.update(num_hidden_layers=2, hidden_size=8, num_attention_heads=2,
                num_key_value_heads=1, intermediate_size=16, vocab_size=300)
    a = Arch(conf)                     # hd 4, vocab padded to 512, bf16
    w = inputs.make_weights(a, 0, "cpu")
    weight_bytes = sum(t.numel() * t.element_size() for k, t in w.items()
                       if k != "embed")
    # per layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8, wi/wg 8x16, w2 16x8 (bf16),
    # bq 8, bk 4, bv 4 (bf16), ln1 + ln2 8 + 8 (fp32); head 8x512; final 8
    layer = (64 + 32 + 32 + 64 + 3 * 128 + 16) * 2 + 16 * 4
    assert weight_bytes == 2 * layer + 8 * 512 * 2 + 8 * 4
    batch, valid = 3, 10
    # k and v of 1 kv head x hd 4 in bf16 a position, 2 layers, 3 rows:
    # the 10 valid positions read and the new one written
    cache = 2 * 3 * (10 + 1) * (2 * 1 * 4 * 2)
    embed_rows = 3 * 8 * 2
    assert arith.decode_step_bytes(a, batch, valid, weight_bytes) == \
        weight_bytes + embed_rows + cache


def test_flash_stage_flops_count_the_visible_pairs():
    # causal S = 4: 10 visible (query, key) pairs a head
    assert arith.flash_stage_flops("fwd", 1, 1, 4, 8) == 4 * 8 * 10
    assert arith.flash_stage_flops("dq", 2, 3, 4, 8) == 6 * 8 * 10 * 6
    assert arith.flash_stage_flops("dkv", 1, 1, 4, 8) == 8 * 8 * 10


def test_qwen3_split_step_is_about_44_teraflops():
    conf = json.loads((ROOT / "bench/configs/qwen3-1.7b.json").read_text())
    assert arith.train_step_flops(Arch(conf), 2, 4096) == pytest.approx(
        44.1e12, rel=0.01)
