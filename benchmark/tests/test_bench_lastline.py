"""The result line has exactly the contract's keys, the check's last; a
machine without the card gets no result and a non-zero exit."""
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness

from conftest import ROOT, TRACE_SECONDS, small_spec


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    result = harness.run_cell("movielens_qem_k30", 7, 0.05, trace, time.perf_counter(),
                              device="cpu", spec=small_spec("movielens_qem_k30"),
                              warn=lambda m: None, trace_seconds=TRACE_SECONDS)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["check"]) == set(harness.cell_spec("movielens_qem_k30")["workload"]["limits"])
    assert all(set(v) == {"value", "limit"} for v in result["check"].values())
    json.dumps(result, allow_nan=False)
    if not trace:
        assert set(result["metrics"]) == {"step_ms", "peak_gb", "setup_s"}


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "movielens_qem_k30", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["covid_qem_k30", "movielens_grouped_vi_k1000",
                                  "movielens_qem_k30"])
def test_cell_on_the_card(cell, card):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", cell, "--seed", "4294967311", "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["metrics"] and result["device"]["busy_s"] > 0
