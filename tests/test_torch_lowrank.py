"""The port's lazy low-rank contraction against ``alan_tpu``'s.

* ``ops/lowrank_kernel.lowrank_logsumexp`` on CPU tensors (its plain
  version) and its autograd gradients against ``alan_tpu``'s
  ``reference_lowrank_logsumexp`` and its Pallas kernel in interpret mode,
  at the shapes of ``tests/test_lowrank_lazy.py:41-46`` plus the -inf-bias
  case: rtol/atol 1e-5 forward, rtol 1e-4 / atol 1e-5 gradients.
* ``LowRankDT`` materialize / contract, on the x side and the parameter
  side, against ``alan_tpu``'s ``LowRankDT``.
* The factored forms of the LogNormal, Exponential, Gamma, Chi2 and Beta
  (rank F = 1 or 2 per positional element): ``lowrank_logprob`` and the
  lazy ``materialize()`` against ``alan_tpu``'s ``lowrank_logprob`` and the
  elementwise density (2e-4, as ``tests/test_ops.py:139-168``), the lazy
  contraction and its gradients against the materialised route, and the
  routing (``ALAN_TPU_NO_LOWRANK_LOGPROB``, ``ALAN_TPU_LOWRANK_MIN``) of
  each family against ``alan_tpu``'s.
* The precision of the CUDA kernels' arithmetic, emulated in torch by
  ``scripts/torch_lowrank_precision.py`` (3xTF32 scores, the backward's
  weights normalised by the rounding of ``out``) on the Normal's factors
  with heavy cancellation and on MovieLens-like ones: out and all three
  gradients as close to an f64 evaluation as the card check asks, where
  the plain f32 version is, or closer than the plain version.
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
from lowrank_operands import normal_factor_operands
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


FACTORED = ["LogNormal", "Exponential", "Gamma", "Chi2", "Beta"]


def _family_pair(family, seed=11):
    """x over (K_z, p), parameters over (K_g, p), positional axis 4, in
    both packages, as ``tests/test_ops.py:139-168`` builds them."""
    rng = np.random.default_rng(seed)
    sizes = {"K_z": 6, "K_g": 5, "p": 3}

    def positive(dims, s=1.0):
        shape = tuple(sizes[d] for d in dims) + (4,)
        return (np.abs(rng.standard_normal(shape)) * s + 0.3).astype(np.float32), dims
    if family == "LogNormal":
        x = positive(("K_z", "p"), 2.0)
        params = {"loc": ((rng.standard_normal((5, 3, 4))).astype(np.float32), ("K_g", "p")),
                  "scale": positive(("K_g", "p"), 0.5)}
    elif family == "Exponential":
        x = positive(("K_z", "p"))
        params = {"rate": positive(("K_g", "p"))}
    elif family == "Gamma":
        x = positive(("K_z", "p"))
        params = {"concentration": positive(("K_g", "p")), "rate": positive(("K_g", "p"))}
    elif family == "Chi2":
        x = positive(("K_z", "p"))
        params = {"df": positive(("K_g", "p"), 3.0)}
    else:  # Beta
        u, dims = positive(("K_z", "p"))
        x = ((u / (u + 1.2)).astype(np.float32), dims)
        params = {"concentration1": positive(("K_g", "p")),
                  "concentration0": positive(("K_g", "p"))}
    j = (jax_dt(x[0], *x[1]), {k: jax_dt(a, *d) for k, (a, d) in params.items()})
    t = (td.DT(torch.as_tensor(x[0]), x[1]),
         {k: td.DT(torch.as_tensor(a), d) for k, (a, d) in params.items()})
    return j, t


def _canonical(family, params, fams):
    return fams.FAMILIES[family].canonicalize(dict(params))


@pytest.mark.parametrize("family", FACTORED)
def test_factored_family_matches_jax(family):
    from alan_tpu.distributions import families as jfam
    from alan_tpu.distributions.dimdist import DimDist as JDimDist
    from alan_tpu_torch.distributions import families as tfam
    (jx, jp), (tx, tp) = _family_pair(family)
    jp, tp = _canonical(family, jp, jfam), _canonical(family, tp, tfam)
    want = jlr.lowrank_logprob(family, jx, jp)
    with Env(ALAN_TPU_NO_LOWRANK_LOGPROB=1):
        elementwise = JDimDist(jfam.FAMILIES[family], **jp).log_prob(jx)
    assert_dt_close(want, td.DT(torch.as_tensor(np.array(
        elementwise.with_dims_front(want.dims).data)), want.dims), 2e-4, 2e-4)
    assert_dt_close(want, tlr.lowrank_logprob(family, tx, tp), 2e-4, 2e-4)
    lazy = tlr.lowrank_logprob_lazy(family, tx, tp)
    F = {"Exponential": 1}.get(family, 2) * 4
    assert lazy.U.pos_shape == (F,) and lazy.V.pos_shape == (F,)
    assert (lazy.x_side is not None) == (family == "LogNormal")
    assert_dt_close(want, lazy.materialize(), 2e-4, 2e-4)
    assert_dt_close(jlr.lowrank_logprob_lazy(family, jx, jp).materialize(),
                    lazy.materialize(), 2e-4, 2e-4)


@pytest.mark.parametrize("family", FACTORED)
def test_factored_family_contract_matches_materialised(family):
    """The lazy factor contracted over K_z (the plain version of the
    kernels on the CPU) against the log-sum-exp of its materialised form,
    value 1e-5 and the gradients of the parameters and of x 1e-4, and
    DimDist reaches the lazy form under the knobs."""
    from alan_tpu_torch.distributions import families as tfam
    from alan_tpu_torch.distributions.dimdist import DimDist as TDimDist
    _, (tx, tp) = _family_pair(family)
    leaves = [v.data.requires_grad_(True) for v in (tx, *tp.values())]
    tpc = _canonical(family, tp, tfam)
    with Env(**PORT_LAZY):
        lazy = TDimDist(tfam.FAMILIES[family], **tp).log_prob(tx)
    assert getattr(lazy, "__lazy_dt__", False)
    calls = tlr.CONTRACT_CALLS
    fused = lazy.contract(("K_z",), [])
    assert tlr.CONTRACT_CALLS == calls + 1
    dense = td.logsumexp_dims(tlr.lowrank_logprob(family, tx, tpc), ("K_z",))
    fused = fused.with_dims_front(list(dense.dims))
    torch.testing.assert_close(fused.data, dense.data, rtol=1e-5, atol=1e-5)
    g_f = torch.autograd.grad(fused.data.sum(), leaves)
    g_d = torch.autograd.grad(dense.data.sum(), leaves)
    for a, b in zip(g_f, g_d):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", FACTORED)
@pytest.mark.parametrize("env,expect", [
    (dict(ALAN_TPU_LOWRANK_MIN=1), True),
    (dict(ALAN_TPU_LOWRANK_MIN=10 ** 9), False),
    (dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_NO_LOWRANK_LOGPROB=1), False),
])
def test_factored_family_routing_matches_jax(family, env, expect):
    from alan_tpu.distributions import families as jfam
    from alan_tpu_torch.distributions import families as tfam
    (jx, jp), (tx, tp) = _family_pair(family)
    jp, tp = _canonical(family, jp, jfam), _canonical(family, tp, tfam)
    with Env(**env):
        assert tlr.lowrank_applicable(family, tx, tp, ("K_g", "p")) == expect
        assert jlr.lowrank_applicable(family, jx, jp, ("K_g", "p")) == expect


def test_lowrank_families_are_alan_tpus():
    assert tlr.LOWRANK_FAMILIES == jlr.LOWRANK_FAMILIES
    assert not tlr.lowrank_applicable("Poisson", td.DT(torch.zeros(3), ("K_z",)),
                                      {"rate": td.DT(torch.ones(4), ("K_g",))}, ("K_g",))


@pytest.mark.parametrize("sizes,env,expect", [
    ((4, 5), dict(ALAN_TPU_LOWRANK_MIN=1), True),
    ((4, 5), dict(ALAN_TPU_LOWRANK_MIN=10 ** 9), False),
    ((4, 5), {}, False),
    ((1 << 13, 1 << 13), {}, False),   # V operand above the 2^26 cap
    ((4, 5), dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_NO_LOWRANK_LOGPROB=1), False),
    ((4, 5), dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LOWRANK_OPERAND_CAP=14), False),
    ((4, 5), dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LOWRANK_OPERAND_CAP=15), True),
    ((1 << 13, 1 << 13), dict(ALAN_TPU_LOWRANK_MIN=1), True),
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


@pytest.mark.parametrize("lazy_min,expect_big,expect_small", [
    (None, True, False), (1, True, True), (10 ** 12, False, False),
    (300 * 1000 * 1000, True, False), (300 * 1000 * 1000 + 1, False, False)])
def test_lazy_min_knob_matches_jax(lazy_min, expect_big, expect_small):
    """``ALAN_TPU_LAZY_LOWRANK_MIN`` moves the lazy crossover in both
    packages alike (the main path's cross is 3e8 elements)."""
    env = {} if lazy_min is None else {"ALAN_TPU_LAZY_LOWRANK_MIN": lazy_min}
    for sizes, expect in (({"K_z": 1000, "plate_1": 300, "K_g": 1000}, expect_big),
                          ({"K_z": 30, "plate_1": 300, "K_g": 30}, expect_small)):
        tx = td.DT(torch.zeros(sizes["K_z"], sizes["plate_1"], 1), ("K_z", "plate_1"))
        tp = {"loc": td.DT(torch.zeros(sizes["K_g"], 1), ("K_g",))}
        jx = jd.DT(jnp.zeros((sizes["K_z"], sizes["plate_1"], 1)), ("K_z", "plate_1"))
        jp = {"loc": jd.DT(jnp.zeros((sizes["K_g"], 1)), ("K_g",))}
        with Env(**env):
            assert tlr.lowrank_lazy_preferred(tx, tp) == expect
            assert jlr.lowrank_lazy_preferred(jx, jp) == expect


def _script(name):
    """A module of ``scripts/``, loaded from its file."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case,offset,scale,spread", [
    ("cancellation", 1.0, 0.3, 3e-4),   # terms 1e2-1e4 times the score
    ("movielens", 0.0, 1.0, 1.0),
])
def test_3xtf32_scores_hold_f32_grade(case, offset, scale, spread):
    pr = _script("torch_lowrank_precision")
    U, V, D, G = (torch.as_tensor(a) for a in normal_factor_operands(
        (1, 4, 200, 50, 36), 17, offset, scale, spread))
    A64 = torch.einsum("spif,sjf->spij", U.double(), V.double()) + D.double()[..., None]
    out64, _ = pr.lse_parts(A64)
    exact = (out64,) + pr.grads(G.double()[:, :, None, :]
                                * torch.exp(A64 - out64[:, :, None]), U, V)
    ts = [t.clone().requires_grad_(True) for t in (U, V, D)]
    plain_out = tk.reference_lowrank_logsumexp(*ts)
    plain = (plain_out.detach(),) + torch.autograd.grad(plain_out, ts, G)
    A3 = pr.scores_3xtf32(U, V) + D[..., None]
    out3, rnd = pr.lse_parts(A3)
    x = A3 - out3[:, :, None]
    emulated = (out3,) + pr.grads(G[:, :, None, :] * torch.exp(x - rnd[:, :, None]), U, V)
    if case == "cancellation":
        Ua = U[0, ::2]    # the cancelling plates
        terms = (Ua[:, :, None, :] * V[0]).abs().amax(-1).double()
        ratio = terms / torch.einsum("pif,jf->pij", Ua.double(), V[0].double()).abs()
        assert 1e2 <= ratio.median() <= 1e4
        # without the rounding of out, dV lies ~10x farther from f64 than
        # the plain version's (the weights of each (p, j) no longer sum to g)
        unnormed = pr.grads(G[:, :, None, :] * torch.exp(x), U, V)[1]
        assert ((unnormed.double() - exact[2]).abs().max()
                > 5 * (plain[2].double() - exact[2]).abs().max())
    # the card check's rule: forward 1e-5, gradients rtol 1e-4 / atol 1e-5,
    # or no farther from f64 than the plain version
    for got, want, exact_, rtol in zip(emulated, plain, exact, (1e-5, 1e-4, 1e-4, 1e-4)):
        err64 = (got.double() - exact_).abs().max()
        plain64 = (want.double() - exact_).abs().max()
        assert torch.allclose(got.double(), exact_, rtol=rtol, atol=1e-5) or err64 <= plain64
    # TF32 alone (one product) is far from f32 grade on the same operands
    one, _ = pr.lse_parts(torch.einsum("spif,sjf->spij", pr.tf32(U), pr.tf32(V)) + D[..., None])
    assert not torch.allclose(one.double(), exact[0], rtol=1e-5, atol=1e-5)


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


def test_probe_marks_every_phase_of_the_kernel():
    """``scripts/torch_lowrank_probe.py --phases`` builds a copy of the
    kernel source with a clock64() mark at each ``// phase:`` comment; every
    comment of the source gets its mark."""
    import os
    probe = _script("torch_lowrank_probe")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "alan_tpu_torch", "csrc", "lowrank_lse.cu")) as fh:
        text = fh.read()
    names = probe.phase_names(text)
    assert names[:4] == ["wait", "stage", "products", "epilogue"] and names[-1] == "done"
    marked = probe.phase_source(text)
    assert marked.count("PHASE_MARK(") == len(names) + 1     # the marks and the macro
    assert probe.phase_names(marked) == []
    assert "lowrank_phase_read" in marked and "lowrank_phase_reset" in marked
