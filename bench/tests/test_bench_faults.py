"""A run whose timed path is broken comes out not correct: the harness
driven on the CPU at a small size (its look for a card skipped), under
the cell's own limits, with the program broken underneath, once for each
fault the cell can have (one chip: no exchange between chips to leave
out). A sound run of the same size comes out correct."""
from __future__ import annotations

import pytest
import torch

from bench import harness
from conftest import small_cell
from repro_torch.models import lm
from repro_torch.train import trainer

TRAIN = ["qwen3-1.7b.split_train_4k", "qwen1.5-0.5b.split_train_4k"]
DECODE = ["qwen3-1.7b.decode_32k", "qwen1.5-0.5b.decode_32k"]


@pytest.fixture(autouse=True)
def _window(steps):
    steps(24)


def run(name, seed=2 ** 31 + 5):
    man, conf, traffic = small_cell(name)
    result, _ = harness.run_cell(man, name, seed, 1.0, False,
                                 torch.device("cpu"), conf=conf,
                                 traffic=traffic)
    return result


@pytest.mark.parametrize("name", TRAIN + DECODE)
def test_sound_run_is_correct(name):
    result = run(name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_returns_its_state_unchanged(name, monkeypatch):
    make = trainer.make_train_step

    def unchanged(*a, **kw):
        step = make(*a, **kw)

        def broken(frozen, B, trainable, opt_state, batch):
            _, _, metrics = step(frozen, B, trainable, opt_state, batch)
            return trainable, opt_state, metrics
        return broken

    monkeypatch.setattr(trainer, "make_train_step", unchanged)
    result = run(name)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name, monkeypatch):
    make = trainer.make_train_step

    def half(*a, **kw):
        step = make(*a, **kw)

        def broken(frozen, B, trainable, opt_state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(frozen, B, trainable, opt_state,
                        {k: v[:rows] for k, v in batch.items()})
        return broken

    monkeypatch.setattr(trainer, "make_train_step", half)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", DECODE)
def test_a_served_token_altered_where_it_is_produced(name, monkeypatch):
    step, calls = lm.decode_step, []

    def altered(cfg, params, cache, token, pos, *a, **kw):
        nxt, cache = step(cfg, params, cache, token, pos, *a, **kw)
        calls.append(pos)
        if len(calls) == 3:      # the window's first step
            nxt = nxt.clone()
            nxt[1, 0] = (nxt[1, 0] + 1) % cfg.vocab_size
        return nxt, cache

    monkeypatch.setattr(lm, "decode_step", altered)
    result = run(name)
    assert not result["correct"], result["checks"]
