"""``--seed`` reaches only the particle draws: two seeds hand the port
byte-identical data and generators in different states."""
import hashlib
import time

import pytest

from benchmark import harness

from conftest import CUTS, small_spec


def _run(cell, seed, monkeypatch):
    import alan_tpu_torch.convert as convert
    from alan_tpu_torch import train
    seen = {"data": hashlib.sha256(), "generators": []}
    real_dt, real_scan = convert.dt_from_numpy, train.scan_steps

    def dt_from_numpy(array, dims=(), device="cuda"):
        import numpy as np
        seen["data"].update(np.ascontiguousarray(array).tobytes())
        return real_dt(array, dims, device)

    def scan_steps(step, n, unroll=None):
        run = real_scan(step, n, unroll)

        def recorded(state, generator):
            seen["generators"].append(generator.get_state().clone())
            return run(state, generator)
        recorded.capture_seconds = 0.0
        return recorded

    monkeypatch.setattr(convert, "dt_from_numpy", dt_from_numpy)
    monkeypatch.setattr(train, "scan_steps", scan_steps)
    harness.run_cell(cell, seed, 0.05, False, time.perf_counter(), device="cpu",
                     spec=small_spec(cell), warn=lambda m: None)
    return seen["data"].hexdigest(), seen["generators"][0]


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_seed_changes_only_the_draws(cell, monkeypatch):
    data_a, gen_a = _run(cell, 1, monkeypatch)
    data_b, gen_b = _run(cell, 2 ** 33 + 5, monkeypatch)
    assert data_a == data_b
    assert not bool((gen_a == gen_b).all())
