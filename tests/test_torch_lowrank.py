"""The port's lazy low-rank contraction against ``alan_tpu``'s.

* ``ops/lowrank_kernel.lowrank_logsumexp`` on CPU tensors (its plain
  version) and its autograd gradients against ``alan_tpu``'s
  ``reference_lowrank_logsumexp`` and its Pallas kernel in interpret mode,
  at the shapes of ``tests/test_lowrank_lazy.py:41-46`` plus the -inf-bias
  case: rtol/atol 1e-5 forward, rtol 1e-4 / atol 1e-5 gradients.
* ``LowRankDT`` materialize / contract, on the x side and the parameter
  side, against ``alan_tpu``'s ``LowRankDT``.
* The wrapper's checks: what the CUDA kernels do not take (another dtype or
  device, a non-contiguous operand, a size beyond their 32-bit ints) raises
  before any launch.  The kernels themselves are tested on the card in
  ``tests/test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alan_tpu.dims as jd
import alan_tpu_torch.dims as td
from alan_tpu.ops import lowrank as jlr
from alan_tpu.ops import pallas_lowrank as jpl
from alan_tpu_torch.ops import lowrank as tlr
from alan_tpu_torch.ops import lowrank_kernel as tk
from test_torch_harness import Env, JAX_LAZY, PORT_LAZY, assert_dt_close, jax_dt

SHAPES = [
    (1, 20, 300, 40, 6),    # single i-tile
    (2, 9, 1300, 130, 4),   # i-tiled + overhang on every axis
    (1, 3, 50, 7, 36),      # tiny j, the main path's F
    (1, 1, 257, 1, 2),      # degenerate plate/parent
]


def _operands(shape, seed, inf_bias=False):
    S, P, I, J, F = shape
    rng = np.random.default_rng(seed)
    U = (rng.standard_normal((S, P, I, F)) * 0.5).astype(np.float32)
    V = (rng.standard_normal((S, J, F)) * 0.5).astype(np.float32)
    D = (rng.standard_normal((S, P, I)) * 2.0).astype(np.float32)
    if inf_bias:
        D = np.where(rng.random((S, P, I)) < 0.3, -np.inf, 0.0).astype(np.float32)
    G = rng.standard_normal((S, P, J)).astype(np.float32)
    return U, V, D, G


def _port_value_and_grads(U, V, D, G):
    ts = [torch.tensor(a, requires_grad=True) for a in (U, V, D)]
    out = tk.lowrank_logsumexp(*ts)
    grads = torch.autograd.grad((out * torch.as_tensor(G)).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_value_and_grads(f, U, V, D, G):
    out = f(U, V, D)
    grads = jax.grad(lambda u, v, d: jnp.sum(f(u, v, d) * G),
                     argnums=(0, 1, 2))(U, V, D)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape,inf_bias",
                         [(s, False) for s in SHAPES] + [((1, 4, 64, 5, 3), True)])
def test_plain_version_matches_jax(shape, inf_bias):
    U, V, D, G = _operands(shape, seed=sum(shape), inf_bias=inf_bias)
    got, ggot = _port_value_and_grads(U, V, D, G)
    if inf_bias:
        assert np.isfinite(got).all()
    # alan_tpu's f32 reference: the stated tolerances.  Its Pallas kernel
    # packs the scores as bf16x3, which at F=36 was measured 1.3e-5 off in
    # the forward and 1.9e-5 off in the gradients, each ~2e-5 from an f64
    # evaluation while the port's plain version stays within 1.2e-6 of it;
    # so against the kernel the absolute tolerance is 5e-5.
    refs = [(jpl.reference_lowrank_logsumexp, 1e-5, 1e-5),
            (lambda u, v, d: jpl.lowrank_logsumexp(u, v, d, True), 5e-5, 5e-5)]
    for f, atol_fwd, atol_grad in refs:
        want, gwant = _jax_value_and_grads(f, U, V, D, G)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol_fwd)
        for a, b in zip(ggot, gwant):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol_grad)


def _lazy_pair(seed=2):
    """A grouped-MovieLens-shaped Normal: x (K_z, p) pos 3, params (K_g)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((40, 7, 3)).astype(np.float32)
    loc = (rng.standard_normal((20, 3)) * 0.3).astype(np.float32)
    scale = np.exp(rng.standard_normal((20, 3)) * 0.2).astype(np.float32)
    j = (jax_dt(x, "K_z", "p"),
         {"loc": jax_dt(loc, "K_g"), "scale": jax_dt(scale, "K_g")})
    t = (td.DT(torch.as_tensor(x), ("K_z", "p")),
         {"loc": td.DT(torch.as_tensor(loc), ("K_g",)),
          "scale": td.DT(torch.as_tensor(scale), ("K_g",))})
    return j, t


def test_lowrank_logprob_and_materialize_match_jax():
    (jx, jp), (tx, tp) = _lazy_pair()
    dense = jlr.lowrank_logprob("Normal", jx, jp)
    assert_dt_close(dense, tlr.lowrank_logprob("Normal", tx, tp), 1e-5, 1e-5)
    assert_dt_close(dense, tlr.lowrank_logprob_lazy("Normal", tx, tp).materialize(),
                    1e-5, 1e-5)


def test_contract_x_side_matches_jax():
    (jx, jp), (tx, tp) = _lazy_pair()
    rng = np.random.default_rng(3)
    xterm = rng.standard_normal((40, 7)).astype(np.float32)
    pterm = rng.standard_normal((20,)).astype(np.float32)
    jz = jlr.lowrank_logprob_lazy("Normal", jx, jp) + jax_dt(xterm, "K_z", "p") \
        - 1.7 + jax_dt(pterm, "K_g")
    tz = tlr.lowrank_logprob_lazy("Normal", tx, tp) \
        + td.DT(torch.as_tensor(xterm), ("K_z", "p")) - 1.7 \
        + td.DT(torch.as_tensor(pterm), ("K_g",))
    assert getattr(tz, "__lazy_dt__", False)
    assert_dt_close(jz.materialize(), tz.materialize(), 1e-5, 1e-5)

    calls = tlr.CONTRACT_CALLS
    fused = tz.contract(("K_z",), [])
    assert tlr.CONTRACT_CALLS == calls + 1
    with Env(**JAX_LAZY):
        jfused = jz.contract(("K_z",), [])
    assert_dt_close(jfused, fused, 1e-5, 1e-5)
    assert_dt_close(jd.logsumexp_dims(jz.materialize(), ("K_z",)), fused,
                    1e-5, 1e-5)

    # a mixed-dims co-factor can't fuse: the caller materialises
    mixed = td.DT(torch.zeros(40, 20), ("K_z", "K_g"))
    assert tz.contract(("K_z",), [mixed]) is None
    assert not getattr(tz + mixed, "__lazy_dt__", False)


def test_contract_param_side_matches_jax():
    """Reduction over the parameter-side K (observation-factor pattern)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((50, 4)).astype(np.float32)
    loc = (rng.standard_normal((30, 4)) * 0.3).astype(np.float32)
    scale = np.exp(rng.standard_normal((30, 4)) * 0.1).astype(np.float32)
    co = rng.standard_normal((30,)).astype(np.float32)
    jz = jlr.lowrank_logprob_lazy(
        "Normal", jax_dt(x, "p"),
        {"loc": jax_dt(loc, "K_w"), "scale": jax_dt(scale, "K_w")}) + jax_dt(co, "K_w")
    tz = tlr.lowrank_logprob_lazy(
        "Normal", td.DT(torch.as_tensor(x), ("p",)),
        {"loc": td.DT(torch.as_tensor(loc), ("K_w",)),
         "scale": td.DT(torch.as_tensor(scale), ("K_w",))}) \
        + td.DT(torch.as_tensor(co), ("K_w",))
    fused = tz.contract(("K_w",), [])
    with Env(**JAX_LAZY):
        assert_dt_close(jz.contract(("K_w",), []), fused, 1e-5, 1e-5)
    assert_dt_close(jd.logsumexp_dims(jz.materialize(), ("K_w",)), fused,
                    1e-5, 1e-5)


@pytest.mark.parametrize("sizes,env,expect", [
    ((4, 5), dict(ALAN_TPU_LOWRANK_MIN=1), True),
    ((4, 5), dict(ALAN_TPU_LOWRANK_MIN=10 ** 9), False),
    ((4, 5), {}, False),
    ((1 << 13, 1 << 13), {}, False),   # V operand above the 2^26 cap
])
def test_routing_matches_jax(sizes, env, expect):
    kz, kg = sizes
    jx = jd.DT(jnp.zeros((kz, 3)), ("K_z",))
    tx = td.DT(torch.zeros(kz, 3), ("K_z",))
    jp = {"loc": jd.DT(jnp.zeros((kg, 3)), ("K_g",))}
    tp = {"loc": td.DT(torch.zeros(kg, 3), ("K_g",))}
    with Env(**env):
        assert tlr.lowrank_applicable("Normal", tx, tp, ("K_g",)) == expect
        assert jlr.lowrank_applicable("Normal", jx, jp, ("K_g",)) == expect
        assert tlr.lowrank_lazy_preferred(tx, tp) == jlr.lowrank_lazy_preferred(jx, jp)
    # no cross product: never routed
    with Env(ALAN_TPU_LOWRANK_MIN=1):
        assert not tlr.lowrank_applicable("Normal", tx, {"loc": td.DT(torch.zeros(3))}, ())


def test_lazy_threshold_matches_jax():
    big = {"K_z": 1000, "plate_1": 300, "K_g": 1000}   # the main path's cross
    small = {"K_z": 30, "plate_1": 300, "K_g": 30}
    for sizes, expect in ((big, True), (small, False)):
        tx = td.DT(torch.zeros(sizes["K_z"], sizes["plate_1"], 1), ("K_z", "plate_1"))
        tp = {"loc": td.DT(torch.zeros(sizes["K_g"], 1), ("K_g",))}
        jx = jd.DT(jnp.zeros((sizes["K_z"], sizes["plate_1"], 1)), ("K_z", "plate_1"))
        jp = {"loc": jd.DT(jnp.zeros((sizes["K_g"], 1)), ("K_g",))}
        assert tlr.lowrank_lazy_preferred(tx, tp) == expect
        assert jlr.lowrank_lazy_preferred(jx, jp) == expect
    with Env(ALAN_TPU_NO_LAZY_LOWRANK=1):
        assert not tlr.lowrank_lazy_preferred(tx, tp)
    with Env(**PORT_LAZY):
        assert tlr.lowrank_lazy_preferred(tx, tp)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "wide", "noncontig"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    # meta tensors, so that each case meets its own check before the device
    # check (and a 2^31-wide feature axis costs no memory)
    def meta(*shape):
        return torch.zeros(*shape, device="meta")
    U, V, D = meta(1, 2, 3, 4), meta(1, 5, 4), meta(1, 2, 3)
    match = {"cpu": "CUDA tensor", "dtype": "float32", "shape": "disagree",
             "wide": "32-bit", "noncontig": "contiguous"}[bad]
    if bad == "cpu":
        U, V, D = torch.zeros(1, 2, 3, 4), torch.zeros(1, 5, 4), torch.zeros(1, 2, 3)
    elif bad == "dtype":
        U = U.double()
    elif bad == "shape":
        D = meta(1, 2, 4)
    elif bad == "wide":
        U, V = meta(1, 2, 3, 2 ** 31), meta(1, 5, 2 ** 31)
    elif bad == "noncontig":
        U = meta(1, 2, 4, 3).transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        tk._check_operands(U, V, D)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    U, V, D, _ = _operands((1, 2, 6, 3, 4), seed=1)
    U, V, D = (torch.as_tensor(a) for a in (U, V, D))
    launches = (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES)
    got = tk.lowrank_logsumexp(U, V, D)
    assert (tk.FWD_LAUNCHES, tk.BWD_LAUNCHES) == launches
    np.testing.assert_array_equal(got.numpy(),
                                  tk.reference_lowrank_logsumexp(U, V, D).numpy())
    with pytest.raises(ValueError):
        tk.lowrank_logsumexp(U, V, D.to("meta"))


def test_dv_chunks():
    assert tk.dv_chunks(1, 300, 1000, 1000) == 293    # ranges of <= 1024 rows
    assert tk.dv_chunks(1, 1, 64, 5) == 2             # ranges of >= 32 rows
    assert tk.dv_chunks(2, 9, 1300, 130) == 132       # enough blocks to fill
