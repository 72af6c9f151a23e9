"""BENCHMARK.json against the contract's shape, and every cell and metric
of it resolving to its files."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "wtbench/run.py"]
    assert BENCH["paths"] == ["wtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"]
                if "workloads" not in m or w["name"] in m["workloads"]]
        assert any(m["name"] == "setup_s" for m in mine)
        assert len(mine) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if "workloads" not in m or w["name"] in m["workloads"]]
        assert layer
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        every = [w["name"] for w in BENCH["workloads"]]
        reporters = e2e[m["moves"]].get("workloads", every)
        for cell in m.get("workloads", reporters):
            assert cell in reporters


def test_layer_names_are_consistent():
    # the splits of one quantity (k1_roofline, k1_roofline.coverage) name one
    # layer, letter for letter
    layer_of = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        stem = m["name"].split(".")[0]
        assert layer_of.setdefault(stem, m["layer"]) == m["layer"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_to_its_files(w):
    from wtbench import harness
    cell = harness.load_cell(REPO, w["name"])
    assert cell.traffic["check"]["limits"]
    cfg_entry = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    cfg = json.loads((REPO / cfg_entry["file"]).read_text())
    assert cfg["name"] == w["config"]
    assert cfg["reduced"] == cfg_entry["reduced"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.readers[m["name"]].read)


def test_every_file_is_named_from_a_name():
    ok = re.compile(r"^[A-Za-z0-9_./-]+$")
    for p in (REPO / "wtbench").rglob("*"):
        if "__pycache__" not in p.parts:
            assert ok.match(str(p.relative_to(REPO))), p
