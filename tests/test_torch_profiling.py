"""The port's tracing and timing helpers (``alan_tpu_torch/profiling.py``)
beside ``alan_tpu.profiling``, on the CPU.

* ``timed_steps``: ``(state, outs, iter_times)`` over the generators, one
  sync a step, as ``alan_tpu``'s over its keys;
* ``trace`` writes a trace file that names the ops run inside it, as
  ``alan_tpu``'s writes its trace directory;
* ``device_memory_stats`` gives None for a device with no allocator
  statistics (the host), as ``alan_tpu``'s does for the CPU.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alan_tpu import profiling as jprofiling
from alan_tpu_torch import profiling, train
from alan_tpu_torch.utils import seeded_generator
from test_torch_parallel import tiny


def test_timed_steps_contract_matches_jax():
    synced = []

    def jstep(state, key):
        return state + 1, jnp.float32(state)

    def tstep(state, gen):
        return state + 1, torch.tensor(float(state))

    jstate, jouts, jtimes = jprofiling.timed_steps(jstep, 0, [jax.random.key(i) for i in range(3)])
    tstate, touts, ttimes = profiling.timed_steps(
        tstep, 0, [seeded_generator(i, "cpu") for i in range(3)],
        sync=lambda out: synced.append(out))
    assert jstate == tstate == 3
    assert [float(o) for o in jouts] == [float(o) for o in touts] == [0.0, 1.0, 2.0]
    assert len(jtimes) == len(ttimes) == 3 and all(t >= 0 for t in ttimes)
    assert len(synced) == 3


def test_timed_steps_drive_a_training_step():
    step, state = train.qem(tiny(), 4, lr=0.1, device="cpu")
    gen = seeded_generator(0, "cpu")
    state, outs, times = profiling.timed_steps(step, state, [gen] * 5)
    assert len(outs) == 5 and all(t > 0 for t in times)
    assert all(np.isfinite(float(e)) for e in outs)


def test_trace_writes_a_file(tmp_path):
    with profiling.trace(str(tmp_path / "port")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "port" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    with jprofiling.trace(str(tmp_path / "jax")):
        jnp.ones((64, 64)) @ jnp.ones((64, 64))
    assert glob.glob(os.path.join(tmp_path, "jax", "**", "*"), recursive=True)


def test_device_memory_stats_on_the_cpu():
    stats = profiling.device_memory_stats()
    assert stats == {"cpu": None}
    assert all(v is None for v in jprofiling.device_memory_stats().values())
