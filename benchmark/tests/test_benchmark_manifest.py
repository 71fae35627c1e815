"""BENCHMARK.json against the contract the harness is written to, and every
entry found by name: configuration, traffic, cell and metric files."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MANIFEST = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells, 14 runs each at run_seconds + 60 s, fits 43,200 s
    n = 24
    assert (2 + 14 * n) * (MANIFEST["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_keys():
    seen = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _one_line(m["layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert {m["name"] for m in MANIFEST["end_to_end"]} >= {"setup_s"}
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] == 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_and_reports(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.workload["name"] == cell
    assert c.config["name"] == c.cell["config"]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    # a per-layer metric's `moves` is reported in every cell it lists
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert set(c.workload["limits"]) == {"cells_unmatched_pct", "value_gap"}


def test_every_config_used_and_pairs_unique():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))

