"""BENCHMARK.json against the benchmark's contract: every cell resolves to
its files, names and units use the allowed characters, every per-layer
metric's end-to-end metric is reported by each of its cells, at most a
quarter of the cells take four chips, and a full check fits its time."""
from __future__ import annotations

import json
import re

import pytest

from bench import harness
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|per_tok|size$)")

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    for word in MAN["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_single_line_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in MAN["workloads"]:
        assert _line(w["why"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MAN["per_layer"]:
        assert _line(m["layer"])


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_resolves_and_cuts_no_width(entry):
    assert entry["file"].startswith("bench/configs/")
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert key in conf and not WIDTH.search(key), key
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_to_its_files(cell):
    harness.config_entry(MAN, cell["config"])
    traffic = json.loads((harness.BENCH / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    assert (harness.BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
    limits = json.loads((harness.BENCH / "cells" /
                         f"{cell['name']}.json").read_text())["limits"]
    assert limits and all(v > 0 for v in limits.values())
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(len(MAN["workloads"]) // 4, 1)


def test_end_to_end_metrics_and_bounds():
    by = {m["name"]: m for m in MAN["end_to_end"]}
    assert by["setup_s"]["bound"] <= 0.25 and "workloads" not in by["setup_s"]
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in MAN["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer_metrics(MAN, cell)


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader_and_its_cells_report_its_move(metric):
    assert metric["workloads"] and set(metric["workloads"]) <= set(CELLS)
    assert (harness.BENCH / "metrics" / f"{metric['name']}.py").is_file()
    assert callable(harness.metric_reader(metric["name"]))
    moves = {m["name"]: m for m in MAN["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moves.get("workloads", CELLS), (metric["name"], cell)
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert metric["layer"] in layers


def test_shares_of_a_peak_are_in_percent():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"] or \
                "share" in m["name"]:
            assert m["unit"] == "%", m["name"]
