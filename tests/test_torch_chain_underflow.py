"""The joint-shift repair of the port's log-space matmuls, on the CPU (the
kernels' plain versions; the kernels themselves are held against these on
the card by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``).

* Peaked operators, as covid's transitions after a few QEM steps: the
  log-density of a Normal of scale 0.01 between particle sets of spread 1.  The separate row and column shifts of ``log(exp(A - rowmax) @
  exp(B - colmax))`` lose every term of most entries there (the value is
  ``log(tiny)`` plus the shifts, its gradient 0).  The small-K chain (K =
  30, T = 16, through ``chain_logmmexp``'s small-K route, its result summed
  out as an ELBO does) and the fused route's product (K = 128, every entry
  weighted) give values within 1e-5 relative and gradients within rtol/atol
  1e-4 of an exact float64 log-space evaluation; the repaired entries are
  counted, and without the repair the gradients miss.
* Operators that do not underflow: no entry is repaired, and values and
  gradients are bitwise those of the port without the repair (the parent's
  arithmetic), and within the existing tolerances of ``alan_tpu``'s
  ``chain_logmmexp`` and ``logmmexp``.
* An entry whose joint max is -inf keeps its old value and passes no
  gradient: an all -inf row of A and column of B give finite gradients, 0
  at those operand entries, through both ``reference_logmmexp`` and the
  plain chain; every other gradient entry is bitwise what the repair
  before this rule gave where that was a number, and within 1e-4 of
  float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu.ops.logmmexp import chain_logmmexp as j_chain
from alan_tpu.ops.logmmexp import logmmexp as j_logmmexp
from alan_tpu_torch.ops import logmmexp as tlm
from alan_tpu_torch.ops import logmmexp_kernel as tlk
from alan_tpu_torch.ops import smallk_kernel as tsk
from test_torch_harness import f64_chain, f64_logmmexp, joint_count, joint_shift_off

SCALE = 0.01


def _peaked(rng, lead, K, steps):
    """``steps`` log-transition operators (lead..., steps, K, K): entry (i, j)
    of operator t is log N(x[t + 1, j]; x[t, i], SCALE), with each step's K
    particles drawn with a spread of 1 around a random walk, as a proposal
    of scale 1 draws them."""
    x = rng.normal(0, 1, (*lead, steps + 1, K))
    x = x + np.cumsum(rng.normal(0, 0.3, (*lead, steps + 1, 1)), axis=-2)
    d = (x[..., 1:, None, :] - x[..., :-1, :, None]) / SCALE
    return (-0.5 * d * d - np.log(SCALE * np.sqrt(2 * np.pi))).astype(np.float32)


def _summed_out(y, W):
    """Each chain's result summed out against other factors W, as an ELBO
    takes it: the chain's own rounding at log-densities of -1e4 then moves
    the gradient only where it matters."""
    return torch.logsumexp((y + W).flatten(-2), -1).sum()


def _linear(y, W):
    """Every entry weighted alike: one product's gradient entry by entry."""
    return (y * W).sum()


def _value_and_grad(f, x, W, objective=_linear):
    x = torch.tensor(x, requires_grad=True)
    y = f(x)
    (g,) = torch.autograd.grad(objective(y, W), [x])
    return y.detach(), g


def _close_to_f64(got, want, rtol):
    """|got - want| <= rtol * max(|want|, 1), elementwise."""
    err = (got.double() - want.double()).abs()
    bound = rtol * want.double().abs().clamp(min=1.0)
    assert bool((err <= bound).all()), float((err / bound).max())


def _peaked_cases():
    rng = np.random.default_rng(0)
    ms = _peaked(rng, (4,), 30, 16)                        # chain: 4 chains, T = 16, K = 30
    AB = _peaked(rng, (2,), 128, 2)                        # product: batch 2, K = 128
    return {"chain": (ms, tlm.chain_logmmexp, f64_chain, _summed_out),
            "fused": (AB, lambda x: tlm.logmmexp(x[:, 0], x[:, 1]),
                      lambda x: f64_logmmexp(x[:, 0], x[:, 1]), _linear)}


@pytest.mark.parametrize("case", ["chain", "fused"])
def test_peaked_matches_float64(case):
    x, f, exact, objective = _peaked_cases()[case]
    K = x.shape[-1]
    W = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (x.shape[0], K, K)).astype(np.float32))
    with joint_count() as joints:
        got, g = _value_and_grad(f, x, W, objective)
    want, gwant = _value_and_grad(lambda t: exact(t.double()).double(), x.astype(np.float64),
                                  W.double(), objective)
    assert int(joints) > 0
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(g).all())
    _close_to_f64(got, want, 1e-5)
    torch.testing.assert_close(g.double(), gwant, rtol=1e-4, atol=1e-4)
    # without the repair most of the gradient is lost
    with joint_shift_off():
        _, g_off = _value_and_grad(f, x, W, objective)
    assert not torch.allclose(g_off.double(), gwant, rtol=1e-4, atol=1e-4)


def test_peaked_chain_small_k_and_dense_routes_agree(monkeypatch):
    """The small-K route's plain version and the dense route repair the
    same entries alike."""
    x, f, _, _ = _peaked_cases()["chain"]
    W = torch.ones(x.shape[0], x.shape[-1], x.shape[-1])
    with joint_count() as small:
        a, ga = _value_and_grad(f, x, W)
    monkeypatch.setenv("ALAN_TPU_NO_SMALLK_CHAIN", "1")
    with joint_count() as dense:
        b, gb = _value_and_grad(f, x, W)
    assert int(small) == int(dense) > 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)


def _plain_cases():
    rng = np.random.default_rng(5)
    ms = (rng.standard_normal((3, 2, 9, 30)) * 2 - 1).astype(np.float32)
    ms = np.repeat(ms[..., None, :], 30, axis=-2) + rng.standard_normal(
        (3, 2, 9, 30, 30)).astype(np.float32)
    A = (rng.standard_normal((2, 40, 130)) * 3).astype(np.float32)
    B = (rng.standard_normal((2, 130, 17)) * 3).astype(np.float32)
    return ms, A, B


def test_unpeaked_is_bitwise_unchanged_and_matches_jax():
    ms, A, B = _plain_cases()
    W = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 2, 30, 30))
                         .astype(np.float32))
    chain = lambda x: tlm.chain_logmmexp(x)
    product = lambda x: tlm.logmmexp(x, torch.from_numpy(B))
    Wp = torch.ones(2, 40, 17)
    with joint_count() as joints:
        y, g = _value_and_grad(chain, ms, W)
        p, gp = _value_and_grad(product, A, Wp)
    assert int(joints) == 0
    with joint_shift_off():
        y0, g0 = _value_and_grad(chain, ms, W)
        p0, gp0 = _value_and_grad(product, A, Wp)
    for a, b in ((y, y0), (g, g0), (p, p0), (gp, gp0)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_chain(jnp.asarray(ms))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(j_logmmexp(
        jnp.asarray(A), jnp.asarray(B), allow_pallas=False)), rtol=1e-5, atol=1e-5)


def test_no_finite_joint_max_keeps_the_old_value():
    """A row of A that is all -inf: c is 0 but no term is finite, so the
    entry keeps ``log(tiny)`` plus the shifts, as before."""
    rng = np.random.default_rng(7)
    A = torch.from_numpy(rng.standard_normal((1, 4, 6)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((1, 6, 5)).astype(np.float32))
    A[0, 2] = -float("inf")
    with joint_count() as joints:
        out = tlk.reference_logmmexp(A, B)
    with joint_shift_off():
        old = tlk.reference_logmmexp(A, B)
    assert int(joints) == 0 and torch.equal(out, old)
    assert bool(torch.isfinite(out[0, 2]).all())


def _repair_passing_old_gradients(out, C, A, B):
    """``joint_repair`` as it was before kept entries stopped their
    gradient: a flagged entry with no finite term keeps ``log(c + tiny)``
    with its autograd."""
    flag = C.detach() < tlk.JOINT_BELOW
    if not bool(flag.any()):
        return out
    *batch, M, N = out.shape
    K = A.shape[-1]
    A3 = A.expand(*batch, M, K).reshape(-1, M, K)
    B3 = B.expand(*batch, K, N).reshape(-1, K, N)
    f3, out3 = flag.reshape(-1, M, N), out.reshape(-1, M, N)
    pairs = f3.flatten(1).any(1).nonzero()[:, 0]
    vals, finite = tlk._JointValues.apply(A3[pairs], B3[pairs])
    out3 = out3.index_put((pairs,), torch.where(f3[pairs] & finite, vals, out3[pairs]))
    return out3.reshape(out.shape)


def _no_finite_term_case(route):
    """(operands, f, exact, objective, W): an all -inf row of A and column
    of B (for the chain also a whole operator), and weights large enough
    that the old gradient's ``g / tiny`` summed over a row overflows.  The
    chain's operators lie near -200, so the ``log(tiny)`` that such an
    entry keeps outweighs its neighbours at the levels above; its
    reference is therefore the plain chain in float64, which keeps
    float32's ``log(tiny)`` too."""
    rng = np.random.default_rng(9)
    if route == "product":   # through the fused route's entry point (K >= 128)
        x = (rng.standard_normal((2, 2, 130, 130)) * 3).astype(np.float32)
        x[0, 0, 3, :] = -np.inf        # a row of A
        x[1, 1, :, 4] = -np.inf        # a column of B
        f = lambda t: tlm.logmmexp(t[:, 0, :6], t[:, 1, :, :7])
        exact = lambda t: f64_logmmexp(t[:, 0, :6], t[:, 1, :, :7])
        W = torch.from_numpy(rng.uniform(3, 4, (2, 6, 7)).astype(np.float32))
        return x, f, exact, _linear, W
    x = (rng.standard_normal((3, 9, 30, 30)) * 3 - 200).astype(np.float32)
    x[0, 2, 4, :] = -np.inf            # a row of A at level 1
    x[1, 5, :, 7] = -np.inf            # a column of B at level 1
    x[2, 6] = -np.inf                  # a whole operator

    def exact(t):                      # the plain chain in float64
        for m in tsk.launch_plan(9, 30):
            t = tsk.reference_segment(t, m)
        return t[:, 0]
    W = torch.from_numpy(rng.uniform(3, 4, (3, 30, 30)).astype(np.float32))
    return x, tlm.chain_logmmexp, exact, _linear, W


@pytest.mark.parametrize("route", ["product", "chain"])
def test_no_finite_term_passes_no_gradient(route, monkeypatch):
    x, f, exact, objective, W = _no_finite_term_case(route)
    y, g = _value_and_grad(f, x, W, objective)
    inf = ~np.isfinite(x)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(g).all())
    assert bool((g[torch.from_numpy(inf)] == 0).all())
    if route == "product":
        # float64 with the -inf entries at -1e30: the outputs with no finite
        # term (about -1e30 there) weigh nothing, and the gradient is
        # bitwise the one of an objective that leaves them out
        x64 = np.where(inf, -1e30, x.astype(np.float64))
        W64 = W.masked_fill(exact(torch.from_numpy(x64)) < -1e29, 0.0)
        assert torch.equal(_value_and_grad(f, x, W64, objective)[1], g)
    else:
        x64, W64 = x.astype(np.float64), W
    _, g64 = _value_and_grad(exact, x64, W64.double(), objective)
    torch.testing.assert_close(g.double(), g64, rtol=1e-4, atol=1e-4)
    # the repair before this rule: NaN beside the kept entries, and every
    # entry where it gave a number bitwise the same
    monkeypatch.setattr(tlk, "joint_repair", _repair_passing_old_gradients)
    monkeypatch.setattr(tsk, "joint_repair", _repair_passing_old_gradients)
    y_old, g_old = _value_and_grad(f, x, W, objective)
    ok = ~torch.isnan(g_old)
    assert not bool(ok.all())
    assert torch.equal(y_old, y) and torch.equal(g_old[ok], g[ok])
