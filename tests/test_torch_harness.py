"""Parity harness between ``alan_tpu`` (JAX) and ``alan_tpu_torch`` (the
PyTorch port), and its own tests.

Data travels between the packages as numpy.  Helpers:

* ``Env``: scoped environment variables (the routing switches of both
  packages are read at call time);
* ``to_numpy_tree``: a JAX tree of ``DT``s with numpy data, which the port's
  ``convert`` module reads;
* ``port_np``: a port ``DT`` as numpy, laid out in a given dim order;
* ``assert_dt_close``: a JAX ``DT`` and a port ``DT`` compared by dim name;
* ``jax_movielens`` / ``port_movielens``: the MovieLens QEM problem,
  grouped or not, in each package, built from the same numpy arrays.

The port runs on the CPU here (``device="cpu"``).
"""
import ast
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples", "models"))

from alan_tpu.dims import DT as JDT  # noqa: E402
from alan_tpu_torch import convert  # noqa: E402
from alan_tpu_torch.dims import DT as TDT  # noqa: E402


class Env:
    """Set environment variables for the duration of a ``with`` block."""

    def __init__(self, **kv):
        self.kv = {k: str(v) for k, v in kv.items()}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *a):
        for k, v in self.old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


#: lazy low-rank path forced in alan_tpu (Pallas kernel in interpret mode)
JAX_LAZY = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK_INTERPRET=1)
#: alan_tpu's dense elementwise log-density, no factored form at all
JAX_DENSE = dict(ALAN_TPU_NO_LOWRANK_LOGPROB=1)
#: lazy low-rank path forced in the port
PORT_LAZY = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK=1)


def to_numpy_tree(tree):
    """Every array leaf of a JAX pytree as numpy (``DT`` keeps its dims)."""
    return jax.tree.map(np.asarray, tree)


def jax_dt(array, *dims):
    return JDT(jnp.asarray(array), dims)


def port_np(x, dims=None):
    """A port DT's data as numpy, with its named dims in ``dims`` order."""
    if dims is not None:
        x = x.with_dims_front(list(dims))
    return x.data.detach().cpu().numpy()


def assert_dt_close(j, t, rtol, atol):
    """A JAX DT and a port DT hold the same dims and values."""
    assert set(j.dims) == set(t.dims), (j.dims, t.dims)
    assert t.pos_shape == tuple(j.pos_shape)
    np.testing.assert_allclose(port_np(t, j.dims), np.asarray(j.data),
                               rtol=rtol, atol=atol)


def assert_tree_close(jtree, ttree, rtol, atol):
    assert set(jtree) == set(ttree)
    for k in jtree:
        if isinstance(jtree[k], dict):
            assert_tree_close(jtree[k], ttree[k], rtol, atol)
        else:
            assert_dt_close(jtree[k], ttree[k], rtol, atol)


def jax_movielens(arrays, grouped=True):
    """MovieLens with a QEM Q on given numpy data: grouped as
    ``bench_scaling._grouped_movielens``, else ``movielens.generate_problem``."""
    import movielens
    from alan_tpu import (Normal, Plate, BoundPlate, Problem, Data, QEMParam,
                          Group)
    d_z = movielens.d_z
    M, N = arrays["obs"].shape
    ps = {"plate_1": M, "plate_2": N}
    cov = {"x": jax_dt(arrays["x"], "plate_1", "plate_2")}
    data = {"obs": jax_dt(arrays["obs"], "plate_1", "plate_2")}
    if not grouped:
        return movielens.generate_problem(ps, data, cov)
    P = movielens.get_P(ps, cov)
    qn = lambda: Normal(QEMParam(jnp.zeros(d_z)), QEMParam(jnp.ones(d_z)))
    Q = Plate(g=Group(mu_z=qn(), psi_z=qn()),
              plate_1=Plate(z=qn(), plate_2=Plate(obs=Data())))
    return Problem(P, BoundPlate(Q, ps, inputs=cov), data)


def port_movielens(arrays, grouped=True, device="cpu"):
    from alan_tpu_torch.models import movielens as tml
    M, N = arrays["obs"].shape
    plates = ("plate_1", "plate_2")
    cov = {"x": convert.dt_from_numpy(arrays["x"], plates, device)}
    data = {"obs": convert.dt_from_numpy(arrays["obs"], plates, device)}
    build = tml.grouped_problem if grouped else tml.generate_problem
    return build({"plate_1": M, "plate_2": N}, data, cov, device)


# ---- the harness's own tests ------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
def test_dt_roundtrip_numpy_jax_port(dtype):
    a = (np.random.default_rng(0).standard_normal((3, 4, 2)) * 10).astype(dtype)
    j = jax_dt(a, "K_z", "p")
    t = convert.dt_from_numpy(np.asarray(j.data), j.dims, "cpu")
    assert isinstance(t, TDT) and t.dims == ("K_z", "p") and t.pos_shape == (2,)
    assert t.data.dtype == (torch.float32 if np.dtype(dtype).kind == "f"
                            else torch.int64)
    np.testing.assert_array_equal(port_np(t), np.asarray(j.data))
    # dims are compared by name, not position
    assert_dt_close(j, TDT(t.data.permute(1, 0, 2), ("p", "K_z")), 0, 0)


def test_tree_and_state_from_numpy():
    arrays = {"x": np.zeros((4, 2, 18), np.float32),
              "obs": np.ones((4, 2), np.float32)}
    jprob = jax_movielens(arrays)
    jstate = to_numpy_tree(jprob.Q.state())
    tstate = convert.state_from_numpy(jstate, "cpu")
    assert set(tstate) == {"opt", "qem_params", "qem_means"}
    assert_tree_close(jprob.Q.state()["qem_params"], tstate["qem_params"], 0, 0)
    assert_tree_close(jprob.Q.state()["qem_means"], tstate["qem_means"], 0, 0)
    # the port builds the same initial state on its own
    tprob = port_movielens(arrays)
    assert_tree_close(jprob.Q.state()["qem_means"],
                      tprob.Q.state()["qem_means"], 0, 0)
    with pytest.raises(KeyError):
        convert.state_from_numpy({"opt": {}}, "cpu")
    tree = convert.tree_from_numpy({"a": jstate["qem_params"]["z_loc"],
                                    "b": {"c": None}}, "cpu")
    assert tree["b"]["c"] is None and tree["a"].dims == ("plate_1",)


def test_env_is_scoped():
    key = "ALAN_TPU_LAZY_LOWRANK"
    before = os.environ.get(key)
    with Env(**{key: 1}):
        assert os.environ[key] == "1"
    assert os.environ.get(key) == before


def _port_sources():
    pkg = os.path.join(REPO, "alan_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_alan_tpu():
    """The port and chip_smoke.py import no JAX and nothing of alan_tpu."""
    paths = list(_port_sources())
    assert len(paths) > 20 and os.path.exists(paths[-1])
    bad = []
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "alan_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_guard_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom jax import numpy\n"
                   "def f():\n    import alan_tpu.dims\n")
    assert set(_imported_modules(str(src))) == {"os", "jax", "alan_tpu.dims"}
