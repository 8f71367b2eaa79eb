"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
found by name from its files, and the file keeps the contract's shape."""
import json
import os
import re

import pytest

from benchmark import check, harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    spec = harness.cell_spec(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    config_dir = spec["config_dir"]
    name = spec["config"]["name"]
    module = harness.load_module(os.path.join(config_dir, f"{name}.py"), "c")
    for fn in ("make_data", "build", "shapes", "step_flops", "record"):
        assert callable(getattr(module, fn))
    ref = harness.load_module(os.path.join(config_dir, f"{name}_reference.py"), "r")
    assert callable(ref.Reference)
    limits = spec["workload"]["limits"]
    assert limits and set(limits) <= set(check.NAMES)
    assert all(0 < v < 1 for v in limits.values())
    assert set(spec["traffic"]) == {"method", "K", "lr", "q", "warm_chunks", "chunk"}
    assert spec["traffic"]["chunk"] >= harness.CHECKED_STEPS
    assert spec["cell"]["chips"] in (1, 4)
    names = {m["name"] for m in spec["end_to_end"]}
    assert {"setup_s", "step_ms"} <= names and spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    module = harness.reader(metric)
    assert callable(module.read)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_and_units():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for config in BENCH["configs"]:
        path = os.path.join(harness.ROOT, config["file"])
        assert os.path.isfile(path) and config["file"].startswith("benchmark/")
        assert config["reduced"] == []
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
