"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``, ``flax``
or ``alan_tpu`` (names compared whole: ``alan_tpu_torch`` is the port),
and the plain references load nothing of the port."""
import json
import os
import subprocess
import sys
import time
import types

import pytest

from benchmark import harness

from conftest import CUTS, ROOT, TRACE_SECONDS, small_spec

RUN = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from benchmark import harness
from conftest import TRACE_SECONDS, small_spec
harness.run_cell({cell!r}, 3, 0.05, True, time.perf_counter(), device="cpu",
                 spec=small_spec({cell!r}), warn=lambda m: None,
                 trace_seconds=TRACE_SECONDS)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
from benchmark import harness
from conftest import small_spec
spec = small_spec({cell!r})
cfg, traffic = spec["config"], spec["traffic"]
c = harness.load_module(spec["config_dir"] + "/" + cfg["name"] + ".py", "c")
data = c.make_data(cfg)
before = {{m.split(".")[0] for m in sys.modules}}
r = harness.load_module(spec["config_dir"] + "/" + cfg["name"] + "_reference.py", "r")
r.Reference(cfg, data, traffic, "cpu").run(5, 1)
r.Reference(cfg, data, traffic, "cpu", dtype=torch.float32, tf32=True).run(5, 1)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}} - before)))
"""


def _modules(code, cell):
    tests = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT, tests=tests, cell=cell)],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_run_loads_no_jax(cell):
    names = _modules(RUN, cell)
    assert "alan_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "alan_tpu"}


@pytest.mark.parametrize("cell", ["covid_qem_k30", "movielens_qem_k30"])
def test_reference_loads_nothing_of_the_port(cell):
    new = _modules(REFERENCE, cell)
    assert not new & {"alan_tpu_torch", "alan_tpu", "jax", "jaxlib", "flax"}


def test_reference_that_loads_jax_gives_no_result(monkeypatch):
    """The modules are looked at again after the reference has run."""
    real = harness.load_module

    def load(path, name):
        module = real(path, name)
        if name.startswith("bench_reference_"):
            class Loading(module.Reference):
                def run(self, *args, **kwargs):
                    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
                    return super().run(*args, **kwargs)
            module.Reference = Loading
        return module

    monkeypatch.setattr(harness, "load_module", load)
    with pytest.raises(RuntimeError, match="flax"):
        harness.run_cell("movielens_qem_k30", 3, 0.05, False, time.perf_counter(),
                         device="cpu", spec=small_spec("movielens_qem_k30"),
                         warn=lambda m: None)
