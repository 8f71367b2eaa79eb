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
  grouped or not, in each package, built from the same numpy arrays;
* ``f64_chain`` / ``f64_chain_route``: the timeseries chain as an exact
  float64 log-space tree, the reference where the separate shifts of
  ``alan_tpu``'s log-matmul underflow; ``joint_shift_off``: the port
  without its joint-shift repair (``alan_tpu``'s arithmetic);
  ``joint_count``: the entries that took the joint shift.

The port runs on the CPU here (``device="cpu"``).
"""
import ast
import contextlib
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
    """A reference DT (JAX's, or the port's own) and a port DT hold the
    same dims and values."""
    assert set(j.dims) == set(t.dims), (j.dims, t.dims)
    assert t.pos_shape == tuple(j.pos_shape)
    ref = port_np(j) if isinstance(j, TDT) else np.asarray(j.data)
    np.testing.assert_allclose(port_np(t, j.dims), ref, rtol=rtol, atol=atol)


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
    return build({"plate_1": M, "plate_2": N}, data, cov, device=device)


# ---- the chain's joint-shift repair ----------------------------------------------

def f64_logmmexp(A, B):
    """``logsumexp_k(A[..., i, k] + B[..., k, j])`` in float64, exactly (the
    K^3 cross sum), cast back to A's type."""
    A64, B64 = A.double(), B.double()
    return torch.logsumexp(A64[..., :, :, None] + B64[..., None, :, :], dim=-2).to(A.dtype)


def f64_chain(ms):
    """``ms[..., T, K, K]`` reduced over T by the port's pairwise tree (the
    odd remainder carried to the end of the next level), each product
    :func:`f64_logmmexp`."""
    x = ms
    while x.shape[-3] != 1:
        n = x.shape[-3]
        prod = f64_logmmexp(x[..., 0:n - n % 2:2, :, :], x[..., 1:n:2, :, :])
        if n % 2:
            prod = torch.cat([prod, x[..., n - 1:, :, :]], dim=-3)
        x = prod
    return x[..., 0, :, :]


@contextlib.contextmanager
def f64_chain_route():
    """The port's timeseries chain (``logpq.chain_logmmexp``) replaced by
    :func:`f64_chain`."""
    from alan_tpu_torch import logpq
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logpq, "chain_logmmexp", f64_chain)
        yield


@contextlib.contextmanager
def joint_shift_off():
    """The port's log-matmuls without the joint-shift repair: no entry is
    below a threshold of 0, so each is ``alan_tpu``'s."""
    from alan_tpu_torch.ops import logmmexp_kernel as tlk
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlk, "JOINT_BELOW", 0.0)
        yield


@contextlib.contextmanager
def joint_count():
    """A one-element tensor that counts the entries taking the joint shift
    while the block runs."""
    from alan_tpu_torch.ops import logmmexp_kernel as tlk
    count = torch.zeros((), dtype=torch.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlk, "JOINT_COUNT", count)
        yield count


# ---- recording the draws -----------------------------------------------------

def _unrolled_scan(f, init, xs=None, length=None, reverse=False, unroll=1,
                   **kw):
    """``jax.lax.scan`` as a Python loop with the same semantics: a draw
    recorded inside the body stays a value of the traced function, where
    inside a real scan it would be a tracer of the scan's own trace."""
    leaves, treedef = jax.tree.flatten(xs)
    n = length if length is not None else leaves[0].shape[0]
    carry, ys = init, []
    for i in (reversed(range(n)) if reverse else range(n)):
        carry, y = f(carry, jax.tree.unflatten(treedef, [x[i] for x in leaves]))
        ys.append(y)
    if reverse:
        ys = ys[::-1]
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def jax_recorded(fn, *args, normals=False):
    """``jax.jit(fn)(*args)`` (one compiled program: eager JAX compiles every
    op of the traversal on its own), and every ``jax.random.categorical``
    call in it recorded: its Gumbel noise, logits and result, as numpy, each
    checked to be ``argmax(noise + logits)``.  ``jax.lax.scan`` runs
    unrolled, so draws inside a scan body (FFBS, a timeseries roll-forward)
    are recorded too.  With ``normals=True`` the standard-normal draws of
    ``jax.random.normal`` are recorded as well, in order, and returned
    third."""
    original = jax.random.categorical
    original_normal = jax.random.normal

    def traced(*args):
        draws, gauss = [], []

        def recorded(key, logits, axis=-1, shape=None, **kw):
            out = original(key, logits, axis=axis, shape=shape, **kw)
            assert axis == -1
            batch = tuple(logits.shape[:-1])
            full = (*(batch if shape is None else tuple(shape)), logits.shape[-1])
            draws.append((jax.random.gumbel(key, full, logits.dtype), logits, out))
            return out

        def recorded_normal(key, shape=(), dtype=jnp.float32, *a, **kw):
            out = original_normal(key, shape, dtype, *a, **kw)
            gauss.append(out)
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "categorical", recorded)
            mp.setattr(jax.random, "normal", recorded_normal)
            mp.setattr(jax.lax, "scan", _unrolled_scan)
            return fn(*args), draws, gauss

    out, draws, gauss = jax.jit(traced)(*args)
    draws = [tuple(np.array(x) for x in d) for d in draws]
    for g, logits, o in draws:
        assert np.array_equal(np.argmax(g + logits, axis=-1), o), "Gumbel mode differs"
    if normals:
        return out, draws, [np.array(x) for x in gauss]
    return out, draws


@contextlib.contextmanager
def port_draws():
    """Record, per draw of the port's replay and FFBS, its noise and
    logits."""
    from alan_tpu_torch import reduce_ks as treduce
    draws = []
    original = treduce.gumbel

    def recorded(shape, like, keygen, noise=None):
        g = original(shape, like, keygen, noise)
        draws.append((g, like))
        return g

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treduce, "gumbel", recorded)
        yield draws


def assert_same_draws(jd, td, rel=1e-4):
    """Each port draw equals alan_tpu's, or is a near-tie: the perturbed
    scores of the two candidates lie within ``rel`` (relative).  Returns
    the number of near-ties."""
    assert len(jd) == len(td)
    ties = 0
    for (g, logits, jout), (tg, tlogits) in zip(jd, td):
        tout = torch.argmax(tg + tlogits, dim=-1).numpy()
        assert tout.shape == jout.shape
        diff = np.nonzero(tout != jout)
        if diff[0].size:
            scores = g + logits
            a = scores[diff + (jout[diff],)]
            b = scores[diff + (tout[diff],)]
            assert np.all(np.abs(a - b) <= rel * np.maximum(1.0, np.abs(a))), (a, b)
            ties += diff[0].size
    return ties


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
    """The port and chip_smoke.py import no JAX, nothing of alan_tpu and
    nothing of examples/ (the port keeps its own grid schema, harnesses
    and examples)."""
    paths = list(_port_sources())
    assert len(paths) > 20 and os.path.exists(paths[-1])
    bad = []
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "alan_tpu", "examples"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_guard_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom jax import numpy\n"
                   "def f():\n    import alan_tpu.dims\n    from examples import gridspec\n")
    assert set(_imported_modules(str(src))) == {"os", "jax", "alan_tpu.dims", "examples"}
