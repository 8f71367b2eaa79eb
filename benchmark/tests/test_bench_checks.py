"""The comparison that decides ``correct`` can fail: the control (the
reference in float32 with TF32 operands, in the program's place) reads
apart from the program at cut sizes, and a run whose timed path is broken
underneath comes out not correct."""
import json
import time

import pytest

from benchmark import harness, study

from conftest import CUTS, small_spec


def _broken(monkeypatch, fault):
    """Break the program's step factories the way ``fault`` says."""
    from alan_tpu_torch import train
    from alan_tpu_torch.dims import DT

    def wrap(factory):
        def make(problem, K, *args, **kwargs):
            if fault == "half":
                return factory(problem, K // 2, *args, **kwargs)
            step, state0 = factory(problem, K, *args, **kwargs)

            def broken(state, generator):
                new, elbo = step(state, generator)
                if fault == "unchanged":
                    return state, elbo
                key = "qem_params" if new[1]["qem_params"] else "opt"
                name = next(iter(new[1][key]))
                old_leaf, new_leaf = state[1][key][name], new[1][key][name]
                moved = DT(2 * new_leaf.data - old_leaf.data, new_leaf.dims)
                Q = {**new[1], key: {**new[1][key], name: moved}}
                return (new[0], Q, *new[2:]), elbo
            return broken, state0
        return make
    monkeypatch.setattr(train, "qem", wrap(train.qem))
    monkeypatch.setattr(train, "vi", wrap(train.vi))


def _correct(cell, seed=11):
    return harness.run_cell(cell, seed, 0.05, False, time.perf_counter(), device="cpu",
                            spec=small_spec(cell), warn=lambda m: None)["correct"]


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_sound_run_is_correct(cell):
    assert _correct(cell)


@pytest.mark.parametrize("fault", ["unchanged", "half", "double"])
@pytest.mark.parametrize("cell", sorted(CUTS))
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    _broken(monkeypatch, fault)
    assert not _correct(cell)


#: covid's control needs the published days: its counts (and the terms
#: that TF32 rounds) grow with them
CONTROL_CUTS = {**CUTS, "covid_qem_k30": ({"nRs": 2}, {"K": 10})}


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_control_reads_apart(cell, capsys):
    config, traffic = CONTROL_CUTS[cell]
    summary = study.main(["--workload", cell, "--device", "cpu", "--seeds", "2",
                          "--control-seeds", "2", "--config", json.dumps(config),
                          "--traffic", json.dumps(traffic)])
    limits = harness.cell_spec(cell)["workload"]["limits"]
    # the control fails one of the cell's numbers, the sound runs none
    assert any(summary["control"][k] > limits[k] for k in limits)
    assert all(summary["sound"][k] <= limits[k] for k in limits)
