"""The port's runner (``python -m alan_tpu_torch.runner``, the counterpart
of ``examples/runner.py``) on the CPU (``--device cpu``).

* the JSON record's keys, on ``synthetic_model`` and ``radon``;
* its ELBOs are ``train.qem``'s from the same seed (iteration i's
  particles from one generator seeded ``seed + 1``), bitwise;
* ``--split`` agrees with the unsplit run within 1e-5;
* ``--fuse-iters`` runs ``train.scan_steps``, which on the CPU is the
  eager loop: the same ELBOs;
* a VI run, ``--out``, and the refusals (``--mesh`` without a process
  group, a plan for a global-K method).
"""
import json

import numpy as np
import pytest

from alan_tpu_torch import runner, train
from alan_tpu_torch.utils import seeded_generator

KEYS = {"model", "method", "K", "lr", "iters", "device", "device_kind",
        "compile_time_s", "mean_iter_time_s", "elbo_start", "elbo_end", "elbos",
        "iter_times", "seed", "peak_memory_bytes"}


def _cli(capsys, *argv):
    runner.main([*argv, "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _train_elbos(model, K, iters, seed, method="qem", lr=0.1):
    problem, *_ = runner.load_model(model, seed, "qem" if method == "qem" else "opt", "cpu")
    step, state = getattr(train, method)(problem, K, lr=lr, device="cpu")
    gen = seeded_generator(seed + 1, "cpu")
    out = []
    for _ in range(iters):
        state, elbo = step(state, gen)
        out.append(float(elbo))
    return out


@pytest.mark.parametrize("model", ["synthetic_model", "radon"])
def test_record_and_elbos_match_train(capsys, model):
    rec = _cli(capsys, "--model", model, "--K", "3", "--iters", "4", "--seed", "2")
    assert KEYS <= set(rec)
    assert rec["device"] == "cpu" and rec["peak_memory_bytes"] is None
    assert len(rec["elbos"]) == len(rec["iter_times"]) == 4
    assert rec["iter_times"][0] == 0.0 and all(t > 0 for t in rec["iter_times"][1:])
    assert rec["mean_iter_time_s"] == pytest.approx(np.mean(rec["iter_times"][1:]))
    assert rec["elbos"] == _train_elbos(model, 3, 4, 2)
    assert rec["elbo_start"] == rec["elbos"][0] and rec["elbo_end"] == rec["elbos"][-1]


def test_split_agrees_with_the_unsplit_run(capsys):
    plain = _cli(capsys, "--model", "radon", "--K", "3", "--iters", "3")
    split = _cli(capsys, "--model", "radon", "--K", "3", "--iters", "3",
                 "--split", "Zips", "20")
    assert split["split"] == ["Zips", 20]
    np.testing.assert_allclose(split["elbos"], plain["elbos"], rtol=1e-5)


def test_fuse_iters_is_the_eager_loop_on_the_cpu(capsys):
    eager = _cli(capsys, "--model", "synthetic_model", "--K", "3", "--iters", "4")
    fused = _cli(capsys, "--model", "synthetic_model", "--K", "3", "--iters", "4",
                 "--fuse-iters")
    assert fused["fused_loop"] is True
    assert fused["elbos"] == eager["elbos"]


def test_vi_run_and_out_file(capsys, tmp_path):
    out = tmp_path / "rec.json"
    rec = _cli(capsys, "--model", "synthetic_model", "--method", "vi", "--K", "3",
               "--iters", "3", "--out", str(out))
    assert json.loads(out.read_text()) == rec
    assert rec["lr"] == 0.01
    assert rec["elbos"] == _train_elbos("synthetic_model", 3, 3, 0, "vi", 0.01)


def test_refusals(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        runner.run("synthetic_model", K=3, iters=1, mesh_spec="p=1",
                   shard_spec="plate_1=p", device="cpu")
    with pytest.raises(ValueError, match="MeshPlan"):
        train.global_qem(runner.load_model("synthetic_model", 0, "qem", "cpu")[0], 3,
                         device="cpu", mesh_plan=object())


@pytest.mark.parametrize("loop", [["--fuse-iters"], ["--runs", "2"]])
def test_fuse_iters_and_runs_with_a_mesh(capsys, tmp_path, loop):
    """``--fuse-iters`` / ``--runs`` with ``--mesh`` (one gloo rank): the
    planned loop runs, its ELBOs those of the eager planned run (the
    first run's, for ``--runs``)."""
    import torch.distributed as dist

    def planned(*extra):
        store = dist.FileStore(str(tmp_path / f"store{len(extra)}"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        return _cli(capsys, "--model", "radon", "--K", "3", "--iters", "3",
                    "--mesh", "p=1", "--shard", "States=p", *extra)
    eager = planned()
    assert not dist.is_initialized() and eager["mesh"] == "p=1"
    fused = planned(*loop)
    assert fused["fused_loop"] is True and fused["mesh"] == "p=1"
    if loop == ["--fuse-iters"]:
        assert fused["elbos"] == eager["elbos"]
    else:
        assert len(fused["per_run_elbos"]) == 2
        assert np.all(np.isfinite(fused["per_run_elbos"]))
