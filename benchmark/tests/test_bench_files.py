"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by name."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from benchmark.harness import Cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # A full check with 24 cells fits its 43200 seconds.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"setup_s", "frames_per_s", "reading_p95_ms"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_name_their_cells_and_move_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        importlib.import_module(f"benchmark.metrics.{m['name']}").read  # noqa: B018
    for w in CELLS:  # every cell reports one per-layer metric at least
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def test_every_configuration_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/") and c["reduced"] == []
        cfg = json.load(open(os.path.join(ROOT, c["file"]), encoding="utf-8"))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    c = Cell.load(cell, ROOT)
    assert c.entry["chips"] == 1
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["feed"] in ("host", "resident")
    assert c.limits["limits"], "a cell compares one number at least"
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "frames_per_s", "reading_p95_ms"}
    for m in c.per_layer:
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            importlib.import_module(f"benchmark.rooflines.{kernel}").bound_ms  # noqa: B018
    importlib.import_module(f"benchmark.scenes.{c.config['run']['scenes']}").maker  # noqa: B018


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        Cell.load("no.such.cell", ROOT)
