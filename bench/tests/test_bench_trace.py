"""The traced run's reduction and the per-layer readers, on made-up
events: busy time is the union of the card's operations inside the
window, idle gaps are named by the span the host was in, kernels group
by name, and each reader returns nothing where it finds nothing to
read."""
from __future__ import annotations

import pytest
import torch

from bench import devtrace, harness

MAN = harness.manifest()


class Ev:
    def __init__(self, name, start, end, kind="kernel", cuda=True):
        self._n, self._s, self._e, self._k, self._c = name, start, end, \
            kind, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return "annotation" in self._k

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else \
            torch.autograd.DeviceType.CPU


def test_busy_groups_and_idle_gaps_by_span():
    ms = 1_000_000
    spans = [(0, 10 * ms, "bench.train_step"),
             (10 * ms, 12 * ms, "bench.readback"),
             (12 * ms, 20 * ms, "bench.train_step")]
    events = [Ev("nvjet_tst_192x192", 1 * ms, 5 * ms),
              Ev("vectorized_elementwise_kernel", 4 * ms, 8 * ms),
              Ev("direct_copy_kernel", 14 * ms, 19 * ms),
              Ev("bench.train_step", 0, 20 * ms, "gpu_user_annotation"),
              Ev("cudaLaunchKernel", 2 * ms, 3 * ms, "cuda_runtime", False)]
    red = devtrace.reduce(events, spans)
    assert red["busy_s"] == pytest.approx(0.012)       # 1-8 and 14-19 ms
    assert red["groups_s"] == pytest.approx(
        {"gemm": 0.004, "elementwise": 0.004, "copy": 0.005})
    idle = dict(red["idle_gaps"])
    # 0-1 ms and 19-20 ms in train_step; 8-14 ms: mid 11 ms in readback
    assert idle == pytest.approx({"bench.train_step": 0.002,
                                  "bench.readback": 0.006})
    assert red["device_events"] == 3


def test_no_device_events_reads_nothing():
    red = devtrace.reduce([], [(0, 5, "bench.decode_step")])
    assert red["busy_s"] == 0.0 and red["idle_gaps"] == []


def _ctx(kind, **kw):
    ctx = {"kind": kind, "window_s": 2.0, "steps_s": [0.2, 0.25, 0.3],
           "n_steps": 3, "counters": {"fwd": 0, "fwd_lse": 0, "dq": 0,
                                      "dkv": 0},
           "trace": {"busy_s": 1.5, "groups_s": {"elementwise": 0.3,
                                                 "copy": 0.6}},
           "work": {"flops_per_step": 1e12, "flops": [1e9] * 3,
                    "bytes": [1e9] * 3,
                    "flash_shape": {"batch": 1, "heads": 2, "kv_heads": 1,
                                    "seq": 8, "hd": 4}},
           "peaks": {"bf16_flops": 1e15, "hbm_bytes": 1e12}}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_each_reader_reads_its_own_kind_only(metric):
    read = harness.metric_reader(metric["name"])
    kind = "train" if metric["name"].endswith(".train") else "decode"
    other = "decode" if kind == "train" else "train"
    assert read(_ctx(other)) is None
    value = read(_ctx(kind, counters={"fwd": 4, "fwd_lse": 1, "dq": 1,
                                      "dkv": 1},
                      trace={"busy_s": 1.5,
                             "groups_s": {"elementwise": 0.3, "copy": 0.6,
                                          "flash_fwd_tensor_cores": 0.01}}))
    assert value is not None and value > 0
    if metric["unit"] == "%":
        assert value <= 100.0


def test_readers_values():
    r = harness.metric_reader
    assert r("step_p50_ms.train")(_ctx("train")) == pytest.approx(250.0)
    assert r("mfu.train")(_ctx("train")) == pytest.approx(
        100 * 3e12 / (1e15 * 2.0))
    assert r("hbm_share.decode")(_ctx("decode")) == pytest.approx(
        100 * 3e9 / (1e12 * 2.0))
    assert r("idle_share.decode")(_ctx("decode")) == pytest.approx(25.0)
    assert r("cache_copy_ms.decode")(_ctx("decode")) == pytest.approx(200.0)
    assert r("flash_roofline.train")(_ctx("train")) is None   # no launches
    assert r("mfu.train")(_ctx("train", peaks=None)) is None
