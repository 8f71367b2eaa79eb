"""The port's grid (``alan_tpu_torch/gridspec.py``, ``runner --grid``,
``run_grid`` and the ``alan-grid`` executor) on the CPU.

* ``gridspec.expand`` equals ``examples/gridspec.py``'s on the specs of
  ``tests/test_examples.py`` and the shipped grids, but for ``platform``,
  which the port passes as ``--device``; ``devices`` is refused;
* a 2-job ``--grid`` run gives the records of two single runs, bitwise;
* ``alan-grid``, built from ``csrc/gridrunner.cpp`` by ``_build``, runs a
  2-job CPU grid to two records, and a rerun skips the jobs marked ok.
"""
import glob
import json
import os
import shlex
import subprocess
import sys

import pytest

from alan_tpu_torch import _build, gridspec, runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import gridspec as jgridspec  # noqa: E402  (examples/gridspec.py)

#: tests/test_examples.py's specs (the first without its ``devices``)
TEST_SPEC = """
defaults:
  iters: 5
  out_dir: res
jobs:
  - model: movielens
    methods: [qem, vi]
    Ks_lrs: {3: [0.1, 0.01], 10: [0.1]}
    seeds: [0, 1]
  - model: covid
    methods: [rws]
    Ks_lrs: {3: [0.01]}
    split: {plate: nRs, size: 23}
    mesh: k=2
    shard_all_k: k
"""
SHADOW_SPEC = {"defaults": {"lr": 0.9, "K": 99, "method": "vi", "seed": 7, "iters": 3},
               "jobs": [{"model": "movielens", "methods": ["qem", "rws"],
                         "Ks_lrs": {30: [0.1, 0.05]}, "seeds": [0, 1]}]}
PLATFORM_SPEC = {"defaults": {"platform": "cpu", "fuse_iters": True},
                 "jobs": [{"model": "radon", "K": 3, "lr": None, "runs": 2,
                           "out": "x.json"},
                          {"model": "covid", "platform": "gpu", "seeds": [0, 1]}]}
GRIDS = sorted(glob.glob(os.path.join(REPO, "examples", "grids", "*.yaml")))


def _spec(text, tmp_path):
    p = tmp_path / "spec.yaml"
    p.write_text(text)
    return str(p)


def _jax_argv(argv):
    """``examples/gridspec.py``'s argv with ``--platform X`` read as the
    port's ``--device`` (``gpu`` as ``cuda``)."""
    out, it = [], iter(argv)
    for a in it:
        if a == "--platform":
            v = next(it)
            out += ["--device", "cuda" if v == "gpu" else v]
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("which", ["test_spec", "shadow", "platform",
                                   *[os.path.basename(g) for g in GRIDS]])
def test_expand_equals_examples_gridspec(which, tmp_path):
    if which == "test_spec":
        spec = gridspec.load_spec(_spec(TEST_SPEC, tmp_path))
        assert spec == jgridspec.load_spec(_spec(TEST_SPEC, tmp_path))
    elif which == "shadow":
        spec = SHADOW_SPEC
    elif which == "platform":
        spec = PLATFORM_SPEC
    else:
        path = os.path.join(REPO, "examples", "grids", which)
        spec = gridspec.load_spec(path)
        assert spec == jgridspec.load_spec(path)
    want = [_jax_argv(a) for a in jgridspec.expand(spec)]
    assert gridspec.expand(spec) == want and want
    assert gridspec.command_lines(spec) == [
        " ".join(["python", "-m", "alan_tpu_torch.runner", *map(shlex.quote, argv)])
        for argv in want]


def test_devices_is_refused(tmp_path):
    with pytest.raises(ValueError, match="devices"):
        gridspec.load_spec(_spec(TEST_SPEC + "    devices: 2\n", tmp_path))
    with pytest.raises(ValueError, match="devices"):
        gridspec.expand({"defaults": {"devices": 8}, "jobs": [{"model": "m"}]})
    with pytest.raises(ValueError, match="nonsense"):
        gridspec.load_spec(_spec("jobs:\n  - model: m\n    nonsense: 1\n", tmp_path))


def _two_jobs(out_dir):
    return {"defaults": {"iters": 3, "platform": "cpu", "out_dir": str(out_dir)},
            "jobs": [{"model": "synthetic_model", "K": 3, "seed": 1},
                     {"model": "radon", "methods": ["qem"], "Ks_lrs": {4: [0.05]}}]}


def _records(out_dir):
    return {os.path.basename(p): json.load(open(p))
            for p in sorted(glob.glob(os.path.join(out_dir, "*.json")))}


def _timeless(rec):
    return {k: v for k, v in rec.items()
            if k not in ("compile_time_s", "mean_iter_time_s", "iter_times")}


def test_grid_runs_give_the_records_of_single_runs(tmp_path, capsys):
    spec = tmp_path / "g.json"
    spec.write_text(json.dumps(_two_jobs(tmp_path / "grid")))
    (tmp_path / "grid").mkdir()
    runner.main(["--grid", str(spec)])
    captured = capsys.readouterr()
    assert captured.err.count("[grid ") == 2
    printed = [json.loads(x) for x in captured.out.strip().splitlines()]
    grid = _records(tmp_path / "grid")
    assert len(grid) == 2 and len(printed) == 2
    (tmp_path / "single").mkdir()
    for argv in gridspec.expand(_two_jobs(tmp_path / "single")):
        runner.main(argv)
    single = _records(tmp_path / "single")
    assert sorted(single) == sorted(grid)
    for name in grid:
        assert _timeless(grid[name]) == _timeless(single[name]), name
    assert [_timeless(p) for p in printed] == [_timeless(grid[n]) for n in
                                               ("synthetic_model_qem_K3.json",
                                                "radon_qem_K4_lr0.05.json")]


def test_grid_refuses_jobs_on_different_devices(tmp_path):
    spec = tmp_path / "g.json"
    spec.write_text(json.dumps({"jobs": [{"model": "radon", "platform": "cpu"},
                                         {"model": "radon", "platform": "gpu"}]}))
    with pytest.raises(SystemExit):
        runner.main(["--grid", str(spec)])
    with pytest.raises(SystemExit):
        runner.main(["--K", "3"])          # --model or --grid


def test_alan_grid_built_from_the_repository_runs_a_grid(tmp_path):
    build = _build.start_grid_runner()
    exe = build.wait()
    assert os.path.basename(exe).startswith("alan-grid-") and os.access(exe, os.X_OK)
    assert exe.startswith(_build.NATIVE_DIR)
    spec = tmp_path / "g.json"
    spec.write_text(json.dumps(_two_jobs(tmp_path / "out")))
    (tmp_path / "out").mkdir()
    status = tmp_path / "status.tsv"
    cmd = [sys.executable, "-m", "alan_tpu_torch.run_grid", str(spec), "-j", "2",
           "-t", "300", "-s", str(status)]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "2 jobs, 0 failed" in p.stderr
    recs = _records(tmp_path / "out")
    assert len(recs) == 2 and all(r["device"] == "cpu" for r in recs.values())
    lines = status.read_text().splitlines()
    assert sum("\tok\t" in line for line in lines) == 2
    cmds = open(str(status) + ".cmds").read().splitlines()
    assert cmds == gridspec.command_lines(_two_jobs(tmp_path / "out"), python=sys.executable)
    # a rerun skips the jobs marked ok
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and status.read_text().splitlines() == lines
