"""The port's distribution families against ``alan_tpu``'s.

The same numpy inputs go through both packages; the port runs on the CPU.

* The registry: every family of ``alan_tpu``'s ``FAMILIES`` in the port with
  identical ``args``, ``arg_event_ndim``, ``event_ndim``, ``support``,
  ``has_rsample`` and ``discrete``.
* Per family, ``log_prob`` at points ``alan_tpu`` draws (at the parameters of
  ``tests/test_families.py``) against ``alan_tpu``'s: rtol/atol 1e-5; and
  against scipy where it has the family, 1e-4 as ``tests/test_families.py``
  (Dirichlet and Wishart 1e-3, as there).
* Per family, the port's draws (2e5, a CPU generator) by the rule of
  ``tests/test_families.py``'s ``check_mean_var``: the mean within 6
  standard errors + atol, the variance within rtol (0.05 unless stated)
  + atol.
* The reparameterised draws: where a draw of ``alan_tpu`` gives its
  standard noise back (the location-scale and inverse-CDF families, and the
  Gamma and Chi2, whose noise is the standard gamma draw), the gradient of
  a function of the port's draw from that noise against ``alan_tpu``'s
  gradient of its draw, rtol 1e-4; the others (Beta, Dirichlet, StudentT,
  FisherSnedecor, Wishart, LKJCholesky: implicit gradients, whose pathwise
  estimator differs from ``alan_tpu``'s) against the analytic gradient of a
  mean, within 6 standard errors.
* ``DimDist`` with event rank 1 and 2 and matrix parameters: draws over
  named dims, and log-densities against ``alan_tpu``'s on the same draws.
* The MultivariateNormal's factor: NaN where the matrix is not positive
  definite, as ``jnp.linalg.cholesky``; a precision matrix gives scipy's
  density, where ``alan_tpu``'s differs (ROADMAP queue 3).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as st
import torch

from alan_tpu.distributions import families as JF
from alan_tpu.distributions.dimdist import DimDist as JDimDist
from alan_tpu_torch.distributions import families as TF
from alan_tpu_torch.distributions.dimdist import DimDist as TDimDist
from alan_tpu_torch import convert
from test_torch_harness import assert_dt_close, jax_dt

N = 200_000
KEY = jax.random.key(0)

_COV = np.array([[2.0, 0.5], [0.5, 1.0]]) @ np.array([[2.0, 0.5], [0.5, 1.0]]).T
_W = np.array([[1.0, 0.5], [-0.3, 0.8]])
_LR_COV = _W @ _W.T + np.diag([0.5, 0.2])
_WISH_V = np.array([[1.0, 0.3], [0.3, 2.0]])
_CAT = np.array([0.2, 0.5, 0.3])


def _cb_moments(p):
    """Mean and variance of ContinuousBernoulli(p) by quadrature."""
    from scipy.integrate import quad
    c = 2 * np.arctanh(1 - 2 * p) / (1 - 2 * p)
    dens = lambda x: c * p ** x * (1 - p) ** (1 - x)
    m = quad(lambda x: x * dens(x), 0, 1)[0]
    return m, quad(lambda x: x * x * dens(x), 0, 1)[0] - m * m


def _weibull_mv(s, k):
    m = s * math.gamma(1 + 1 / k)
    return m, s * s * math.gamma(1 + 2 / k) - m * m


#: name -> (params, scipy distribution or None, (mean, var, rtol) or None,
#:          event shape of a draw)
CASES = {
    "Normal": ({"loc": 1.5, "scale": 2.0}, st.norm(1.5, 2.0), (1.5, 4.0, 0.05), ()),
    "HalfNormal": ({"scale": 2.0}, st.halfnorm(0, 2.0),
                   (2.0 * np.sqrt(2 / np.pi), 4.0 * (1 - 2 / np.pi), 0.05), ()),
    "Cauchy": ({"loc": 0.5, "scale": 1.5}, st.cauchy(0.5, 1.5), None, ()),
    "HalfCauchy": ({"scale": 1.5}, st.halfcauchy(0, 1.5), None, ()),
    "LogNormal": ({"loc": 0.2, "scale": 0.5}, st.lognorm(s=0.5, scale=np.exp(0.2)),
                  (np.exp(0.325), (np.exp(0.25) - 1) * np.exp(0.65), 0.05), ()),
    "Uniform": ({"low": -1.0, "high": 3.0}, st.uniform(-1.0, 4.0), (1.0, 16 / 12, 0.05), ()),
    "Exponential": ({"rate": 2.0}, st.expon(scale=0.5), (0.5, 0.25, 0.05), ()),
    "Gamma": ({"concentration": 3.0, "rate": 2.0}, st.gamma(3.0, scale=0.5),
              (1.5, 0.75, 0.05), ()),
    "Chi2": ({"df": 5.0}, st.chi2(5.0), (5.0, 10.0, 0.05), ()),
    "Beta": ({"concentration1": 2.0, "concentration0": 3.0}, st.beta(2.0, 3.0),
             (0.4, 0.04, 0.05), ()),
    "StudentT": ({"df": 5.0, "loc": 1.0, "scale": 2.0}, st.t(5.0, 1.0, 2.0),
                 (1.0, 4.0 * 5 / 3, 0.1), ()),
    "Laplace": ({"loc": 0.5, "scale": 1.5}, st.laplace(0.5, 1.5), (0.5, 4.5, 0.05), ()),
    "Gumbel": ({"loc": 0.5, "scale": 1.5}, st.gumbel_r(0.5, 1.5),
               (0.5 + 1.5 * np.euler_gamma, (np.pi * 1.5) ** 2 / 6, 0.05), ()),
    "Kumaraswamy": ({"concentration1": 2.0, "concentration0": 3.0}, None,
                    (3.0 * sps.beta(1.5, 3.0),
                     3.0 * sps.beta(2.0, 3.0) - (3.0 * sps.beta(1.5, 3.0)) ** 2, 0.05), ()),
    "Pareto": ({"scale": 1.0, "alpha": 3.0}, st.pareto(3.0), (1.5, 0.75, 0.3), ()),
    "Weibull": ({"scale": 2.0, "concentration": 1.5}, st.weibull_min(1.5, scale=2.0),
                (*_weibull_mv(2.0, 1.5), 0.05), ()),
    "FisherSnedecor": ({"df1": 5.0, "df2": 8.0}, st.f(5.0, 8.0),
                       (8 / 6, 2 * 8 ** 2 * 11 / (5 * 36 * 4), 0.2), ()),
    "VonMises": ({"loc": 0.5, "concentration": 2.0}, st.vonmises(2.0, loc=0.5), None, ()),
    "Bernoulli": ({"probs": 0.3}, st.bernoulli(0.3), (0.3, 0.21, 0.05), ()),
    "ContinuousBernoulli": ({"probs": 0.3}, None, (*_cb_moments(0.3), 0.05), ()),
    "Binomial": ({"total_count": 10.0, "probs": 0.3}, st.binom(10, 0.3), (3.0, 2.1, 0.05), ()),
    "Poisson": ({"rate": 4.0}, st.poisson(4.0), (4.0, 4.0, 0.05), ()),
    "Geometric": ({"probs": 0.3}, st.geom(0.3, loc=-1), (0.7 / 0.3, 0.7 / 0.09, 0.1), ()),
    "NegativeBinomial": ({"total_count": 5.0, "probs": 0.4}, st.nbinom(5, 0.6),
                         (5 * 0.4 / 0.6, 5 * 0.4 / 0.36, 0.1), ()),
    "Categorical": ({"probs": _CAT}, None, (_CAT @ np.arange(3), _CAT @ np.arange(3) ** 2
                                            - (_CAT @ np.arange(3)) ** 2, 0.05), ()),
    "OneHotCategorical": ({"probs": _CAT}, None, (_CAT, _CAT * (1 - _CAT), 0.05), (3,)),
    "Multinomial": ({"total_count": 4.0, "probs": _CAT}, st.multinomial(4, _CAT),
                    (4 * _CAT, 4 * _CAT * (1 - _CAT), 0.05), (3,)),
    "Dirichlet": ({"concentration": np.array([2.0, 3.0, 5.0])},
                  st.dirichlet(np.array([2.0, 3.0, 5.0])),
                  (np.array([0.2, 0.3, 0.5]),
                   np.array([0.2, 0.3, 0.5]) * (1 - np.array([0.2, 0.3, 0.5])) / 11, 0.05),
                  (3,)),
    "MultivariateNormal": ({"loc": np.array([1.0, -1.0]), "covariance_matrix": _COV},
                           st.multivariate_normal(np.array([1.0, -1.0]), _COV),
                           (np.array([1.0, -1.0]), np.diag(_COV), 0.05), (2,)),
    "LowRankMultivariateNormal": (
        {"loc": np.array([0.5, 0.0]), "cov_factor": _W, "cov_diag": np.array([0.5, 0.2])},
        st.multivariate_normal(np.array([0.5, 0.0]), _LR_COV),
        (np.array([0.5, 0.0]), np.diag(_LR_COV), 0.05), (2,)),
    "LogitRelaxedBernoulli": ({"temperature": 0.5, "logits": 0.4},
                              st.logistic(0.8, 2.0), (0.8, 4.0 * np.pi ** 2 / 3, 0.05), ()),
    "RelaxedBernoulli": ({"temperature": 0.5, "probs": 0.3}, None, None, ()),
    "RelaxedOneHotCategorical": ({"temperature": 0.7, "probs": _CAT}, None, None, (3,)),
    "Wishart": ({"df": 5.0, "covariance_matrix": _WISH_V}, st.wishart(5.0, _WISH_V),
                (5.0 * _WISH_V, 5.0 * (_WISH_V ** 2 + np.outer(np.diag(_WISH_V),
                                                                np.diag(_WISH_V))), 0.05),
                (2, 2)),
    "LKJCholesky": ({"dim": 3, "concentration": 1.5}, None, None, (3, 3)),
}


def _jparams(p):
    return {k: (jnp.asarray(v, jnp.float32) if isinstance(v, np.ndarray) else v)
            for k, v in p.items()}


def _tparams(p, fam):
    out = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in p.items()}
    return fam.canonicalize(out)


def _jax_draws(name, n):
    params, _, _, ev = CASES[name]
    jp = JF.FAMILIES[name].canonicalize(_jparams(params))
    return np.asarray(JF.FAMILIES[name].sample(KEY, (n, *ev), jp)), jp


# ---- the registry ------------------------------------------------------------------

def test_registry_matches_jax():
    assert list(TF.FAMILIES) == list(JF.FAMILIES)
    for name, jf in JF.FAMILIES.items():
        tf = TF.FAMILIES[name]
        for attr in ("name", "args", "arg_event_ndim", "event_ndim", "support",
                     "has_rsample", "discrete"):
            assert getattr(tf, attr) == getattr(jf, attr), (name, attr)
    assert TF.Chi2.canonicalize({"df": 5.0}) == JF.Chi2.canonicalize({"df": 5.0})
    assert TF.LKJCholesky.event_shape({"dim": 4.0}) == JF.LKJCholesky.event_shape({"dim": 4.0})
    assert set(CASES) == set(JF.FAMILIES)


# ---- log-densities -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_log_prob_matches_jax_and_scipy(name):
    params, sp, _, ev = CASES[name]
    jfam, tfam = JF.FAMILIES[name], TF.FAMILIES[name]
    x, jp = _jax_draws(name, 50)
    want = np.asarray(jfam.log_prob(jnp.asarray(x), jp))
    got = tfam.log_prob(torch.from_numpy(np.array(x)), _tparams(params, tfam)).numpy()
    assert got.shape == want.shape == (50,)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if sp is None:
        return
    if name == "Wishart":
        theirs = np.array([sp.logpdf(q) for q in x.astype(np.float64)])
        tol = 1e-3
    elif name == "Dirichlet":
        x64 = np.clip(x.astype(np.float64), 1e-6, 1)
        theirs = np.array([sp.logpdf(q / q.sum()) for q in x64])
        tol = 1e-3
    else:
        theirs = sp.logpmf(x) if hasattr(sp, "logpmf") else sp.logpdf(x)
        tol = 1e-4
    np.testing.assert_allclose(got, theirs, rtol=tol, atol=tol)


def test_log_prob_at_the_edges_matches_jax():
    """Outside the support (-inf), logits instead of probs, and the
    ContinuousBernoulli's Taylor branch at probs 0.5."""
    x = np.array([-1.0, 0.5, 2.0], np.float32)
    for name, p in (("HalfNormal", {"scale": 2.0}), ("HalfCauchy", {"scale": 1.5}),
                    ("Uniform", {"low": 0.0, "high": 1.0}),
                    ("Pareto", {"scale": 1.0, "alpha": 3.0})):
        want = np.asarray(JF.FAMILIES[name].log_prob(jnp.asarray(x), p))
        got = TF.FAMILIES[name].log_prob(torch.from_numpy(x), _tparams(p, TF.FAMILIES[name]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    u = np.linspace(0.05, 0.95, 7).astype(np.float32)
    for name, p in (("Bernoulli", {"logits": 0.7}), ("Geometric", {"logits": -0.4}),
                    ("ContinuousBernoulli", {"probs": 0.50003}),
                    ("ContinuousBernoulli", {"logits": 1.3}),
                    ("Binomial", {"total_count": 10.0, "logits": -0.2}),
                    ("NegativeBinomial", {"total_count": 3.0, "logits": 0.3})):
        xx = np.round(u * 9) if TF.FAMILIES[name].discrete else u
        if name == "Bernoulli":
            xx = np.round(u)
        want = np.asarray(JF.FAMILIES[name].log_prob(jnp.asarray(xx), p))
        got = TF.FAMILIES[name].log_prob(torch.from_numpy(xx), _tparams(p, TF.FAMILIES[name]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    lg = np.array([0.3, -1.2, 0.4], np.float32)
    for name in ("Categorical", "OneHotCategorical"):
        xx = (np.array([0.0, 1.0, 2.0]) if name == "Categorical"
              else np.eye(3)).astype(np.float32)
        want = np.asarray(JF.FAMILIES[name].log_prob(jnp.asarray(xx), {"logits": jnp.asarray(lg)}))
        got = TF.FAMILIES[name].log_prob(torch.from_numpy(xx), {"logits": torch.from_numpy(lg)})
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---- the port's draws ------------------------------------------------------------------

def _port_draws(name, n=N, seed=0):
    params, _, _, ev = CASES[name]
    tfam = TF.FAMILIES[name]
    return tfam.sample(torch.Generator().manual_seed(seed), (n, *ev),
                       _tparams(params, tfam)).numpy()


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2] is not None])
def test_sample_moments(name):
    """``check_mean_var``'s rule, elementwise over a vector or matrix
    event; the Categorical by its category counts."""
    mean, var, rtol = CASES[name][2]
    x = _port_draws(name)
    assert np.all(np.isfinite(x))
    se = np.sqrt(np.asarray(var) / N)
    assert np.all(np.abs(x.mean(0) - mean) < 6 * se + 0.02), (x.mean(0), mean)
    assert np.allclose(x.var(0), var, rtol=rtol, atol=0.02), (x.var(0), var)


def test_sample_supports_and_shapes():
    """Draws lie in their supports; the families without moments above by
    their own criteria (``tests/test_families.py``'s for the VonMises and
    the Kumaraswamy)."""
    x = _port_draws("VonMises")
    assert np.all(np.abs(x) <= np.pi)
    assert abs(np.angle(np.exp(1j * x).mean()) - 0.5) < 0.02
    assert abs(np.abs(np.exp(1j * x).mean()) - sps.i1(2.0) / sps.i0(2.0)) < 0.01
    for name in ("Cauchy", "HalfCauchy"):
        x = _port_draws(name)
        lo, hi = CASES[name][1].ppf([0.25, 0.75])
        assert abs(np.mean((x > lo) & (x < hi)) - 0.5) < 0.005, name
    x = _port_draws("RelaxedBernoulli")
    # a float32 sigmoid rounds to 0 or 1 in the far tails
    assert np.all((x >= 0) & (x <= 1))
    # RelaxedBernoulli(t, p) is the sigmoid of LogitRelaxedBernoulli's logistic
    lo = st.logistic(math.log(0.3 / 0.7) / 0.5, 2.0).cdf(0.0)
    assert abs(np.mean(x < 0.5) - lo) < 0.005
    x = _port_draws("RelaxedOneHotCategorical")
    np.testing.assert_allclose(x.sum(-1), 1.0, rtol=1e-5)
    assert np.allclose(np.bincount(x.argmax(-1), minlength=3) / N, _CAT, atol=0.01)
    L = _port_draws("LKJCholesky", n=20000)
    assert np.allclose(np.triu(L, 1), 0.0)
    C = L @ np.swapaxes(L, -1, -2)
    np.testing.assert_allclose(np.diagonal(C, axis1=-2, axis2=-1), 1.0, rtol=1e-5)
    # LKJ(eta): each off-diagonal correlation ~ 2 Beta(b, b) - 1, b = eta - 1 + d/2
    b = 1.5 - 1 + 1.5
    assert abs(C[:, 1, 0].var() - 1 / (2 * b + 1)) < 0.01
    assert np.all(np.linalg.eigvalsh(_port_draws("Wishart", n=1000)) > 0)
    k = _port_draws("Multinomial", n=1000)
    assert np.all(k.sum(-1) == 4) and np.all(k == np.round(k))


# ---- reparameterised gradients --------------------------------------------------------

#: noise of ``alan_tpu``'s draw x at params p, and the port's noise of it
INVERTIBLE = {
    "Normal": lambda x, p: (x - p["loc"]) / p["scale"],
    "HalfNormal": lambda x, p: x / p["scale"],
    "Cauchy": lambda x, p: (x - p["loc"]) / p["scale"],
    "HalfCauchy": lambda x, p: x / p["scale"],
    "LogNormal": lambda x, p: (np.log(x) - p["loc"]) / p["scale"],
    "Uniform": lambda x, p: (x - p["low"]) / (p["high"] - p["low"]),
    "Exponential": lambda x, p: x * p["rate"],
    "Gamma": lambda x, p: x * p["rate"],
    "Chi2": lambda x, p: x * 0.5,
    "Laplace": lambda x, p: (x - p["loc"]) / p["scale"],
    "Gumbel": lambda x, p: (x - p["loc"]) / p["scale"],
    "Kumaraswamy": lambda x, p: (1 - x ** p["concentration1"]) ** p["concentration0"],
    "Pareto": lambda x, p: (x / p["scale"]) ** (-p["alpha"]),
    "Weibull": lambda x, p: np.exp(-(x / p["scale"]) ** p["concentration"]),
    "ContinuousBernoulli": None,
    "MultivariateNormal": lambda x, p: np.linalg.solve(np.linalg.cholesky(p["covariance_matrix"]),
                                                       (x - p["loc"]).T).T,
    "LowRankMultivariateNormal": lambda x, p: np.linalg.solve(np.linalg.cholesky(_LR_COV),
                                                              (x - p["loc"]).T).T,
    "LogitRelaxedBernoulli": lambda x, p: sps.expit(x * p["temperature"] - p["logits"]),
    "RelaxedBernoulli": lambda x, p: sps.expit(sps.logit(x) * p["temperature"]
                                               - math.log(0.3 / 0.7)),
    "RelaxedOneHotCategorical": None,
}


def _loss(x, lib):
    """A smooth function of a draw whose gradient reaches every parameter."""
    return (lib.sin(x) * (1.0 + 0.1 * x)).sum()


@pytest.mark.parametrize("name", [n for n, f in INVERTIBLE.items() if f is not None])
def test_reparam_gradient_matches_jax(name):
    """alan_tpu's draw and its gradient; the port's draw from the noise it
    gives back, and its gradient: draws 1e-4, gradients rtol 1e-4."""
    params, _, _, ev = CASES[name]
    jfam, tfam = JF.FAMILIES[name], TF.FAMILIES[name]
    jp0 = _jparams(params)
    keys = [k for k, v in params.items() if k not in ("dim",)]

    def jloss(jp):
        return _loss(jfam.sample(KEY, (400, *ev), jfam.canonicalize({**jp0, **jp})), jnp)
    jgrads = jax.grad(jloss)({k: jnp.asarray(jp0[k], jnp.float32) for k in keys})
    x, _ = _jax_draws(name, 400)
    np_params = {k: np.asarray(v, np.float64) for k, v in params.items()}
    eps = torch.from_numpy(np.asarray(INVERTIBLE[name](x.astype(np.float64), np_params),
                                      np.float32))
    tp = {k: torch.tensor(np.asarray(v, np.float32), requires_grad=True)
          for k, v in params.items()}
    draw = tfam.from_noise(eps, tfam.canonicalize(dict(tp)))
    np.testing.assert_allclose(draw.detach().numpy(), x, rtol=1e-4, atol=1e-4)
    tgrads = torch.autograd.grad(_loss(draw, torch), [tp[k] for k in keys])
    for k, g in zip(keys, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), rtol=1e-4, atol=1e-3,
                                   err_msg=f"{name} d/d{k}")


#: name -> (parameter, statistic of a draw, d E[statistic] / d parameter)
ANALYTIC_GRADS = {
    "Beta": ("concentration1", lambda x: x, 3.0 / 25.0),
    "Dirichlet": ("concentration", lambda x: x[..., 0],
                  np.array([8.0, -2.0, -2.0]) / 100.0),
    "StudentT": ("df", lambda x: (x - 1.0) ** 2, -2 * 4.0 / 9.0),
    "FisherSnedecor": ("df2", lambda x: x, -2.0 / 36.0),
    "Wishart": ("df", lambda x: x, _WISH_V),
    "LKJCholesky": ("concentration", lambda x: x[..., 1, 0] ** 2, -0.5 / (0.5 + 1.5 + 0.5) ** 2),
    "Gamma": ("concentration", lambda x: x, 0.5),
}


@pytest.mark.parametrize("name", list(ANALYTIC_GRADS))
def test_reparam_gradient_is_unbiased(name):
    """The mean of the pathwise gradients of a statistic over 2e5 draws
    (2e4 for the matrix families) is the analytic gradient of its mean,
    within 6 standard errors + 1e-3: the implicit gradients of the gamma,
    Beta and Dirichlet draws.  Each draw gets its own copy of the
    parameter, so one backward pass gives every draw's gradient.  For the
    LKJCholesky at d = 3 the statistic is L[1, 0]^2, the first row's
    Beta(1/2, eta + 1/2) draw."""
    param, stat, want = ANALYTIC_GRADS[name]
    params, _, _, ev = CASES[name]
    tfam = TF.FAMILIES[name]
    n = 20000 if len(ev) == 2 else N
    tp = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}
    leaf = tp[param].expand((n, *tp[param].shape)).clone().requires_grad_(True)
    tp[param] = leaf
    p = tfam.canonicalize(dict(tp))
    draw = tfam.from_noise(tfam.noise(torch.Generator().manual_seed(3), (n, *ev), p), p)
    flat = stat(draw).reshape(n, -1)
    got, se = [], []
    for j in range(flat.shape[1]):
        (g,) = torch.autograd.grad(flat[:, j].sum(), [leaf], retain_graph=True)
        g = g.double().numpy()
        got.append(g.mean(0))
        se.append(g.std(0) / math.sqrt(n))
    got = np.reshape(got, np.shape(want))
    se = np.reshape(se, np.shape(want))
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got - want) < 6 * se + 1e-3), (got, want, se)


def test_from_noise_is_sample_and_checks_the_noise_shape():
    """``sample`` is ``from_noise`` of ``noise`` from the same generator,
    and ``DimDist`` takes a noise of two numbers per draw on a last axis
    for the StudentT."""
    for name in ("Gamma", "StudentT", "Wishart", "LKJCholesky", "Dirichlet"):
        params, _, _, ev = CASES[name]
        tfam = TF.FAMILIES[name]
        p = _tparams(params, tfam)
        a = tfam.sample(torch.Generator().manual_seed(1), (5, *ev), p)
        b = tfam.from_noise(tfam.noise(torch.Generator().manual_seed(1), (5, *ev), p), p)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dd = TDimDist(TF.StudentT, df=5.0, loc=convert.dt_from_numpy(
        np.zeros(3, np.float32), ("K_a",), "cpu"), scale=2.0)
    eps = torch.randn(4, 3, 2)
    out = dd.sample(None, True, ["K_b", "K_a"], {"K_b": 4}, noise=eps)
    assert out.dims == ("K_b", "K_a") and out.pos_shape == ()
    with pytest.raises(ValueError, match="noise shape"):
        dd.sample(None, True, ["K_b", "K_a"], {"K_b": 4}, noise=eps[..., 0])


# ---- DimDist with vector and matrix events ------------------------------------------------

@pytest.mark.parametrize("name,params", [
    ("MultivariateNormal", {"loc": ("K_a", np.array([[0.5, -1.0], [1.0, 0.0], [0.0, 2.0]])),
                            "covariance_matrix": _COV}),
    ("Dirichlet", {"concentration": ("K_a", np.array([[2.0, 3.0, 5.0], [1.0, 1.0, 0.5],
                                                      [4.0, 2.0, 1.0]]))}),
    ("Wishart", {"df": ("K_a", np.array([4.0, 5.0, 7.0])), "covariance_matrix": _WISH_V}),
    # alan_tpu's LKJCholesky broadcasts a concentration that carries a dim
    # against the event's last axis, so it takes a number here
    ("LKJCholesky", {"dim": 3.0, "concentration": 1.5}),
    ("Multinomial", {"total_count": 5, "logits": ("K_a", np.log(np.array(
        [[0.2, 0.5, 0.3], [0.6, 0.2, 0.2], [0.1, 0.1, 0.8]])))}),
])
def test_dimdist_vector_and_matrix_events_match_jax(name, params):
    """A draw over K_b and the plate p, with parameters carrying K_a;
    then both packages' log-densities of the same draw (named dims K_b,
    p, K_a; the event summed): 1e-5."""
    jargs, targs = {}, {}
    for k, v in params.items():
        if isinstance(v, tuple):
            jargs[k] = jax_dt(np.asarray(v[1], np.float32), v[0])
            targs[k] = convert.dt_from_numpy(np.asarray(v[1], np.float32), (v[0],), "cpu")
        else:
            jargs[k] = jnp.asarray(v, jnp.float32) if isinstance(v, np.ndarray) else v
            targs[k] = torch.tensor(np.asarray(v, np.float32)) if isinstance(v, np.ndarray) else v
    td = TDimDist(TF.FAMILIES[name], **targs)
    draw = td.sample(torch.Generator().manual_seed(0), False, ["K_b", "p", "K_a"],
                     {"K_b": 4, "p": 2, "K_a": 3})
    ev = {"MultivariateNormal": (2,), "Dirichlet": (3,), "Wishart": (2, 2),
          "LKJCholesky": (3, 3), "Multinomial": (3,)}[name]
    assert set(draw.dims) == {"K_b", "p", "K_a"} and draw.pos_shape == ev
    x = draw.with_dims_front(["K_b", "p", "K_a"])
    jx = jax_dt(x.data.numpy(), *x.dims)
    tx = convert.dt_from_numpy(x.data.numpy(), x.dims, "cpu")
    want = JDimDist(JF.FAMILIES[name], **jargs).log_prob(jx)
    got = td.log_prob(tx)
    assert torch.isfinite(got.data).all()
    assert_dt_close(want, got, 1e-5, 1e-5)


# ---- the MultivariateNormal's factor --------------------------------------------------------

def test_mvn_factor_is_nan_where_not_positive_definite():
    """``jnp.linalg.cholesky`` gives NaN in the lower triangle of a matrix
    that is not positive definite, and raises nothing; so does the port,
    and its density there is NaN."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
    got = TF.MultivariateNormal._chol({"covariance_matrix": torch.from_numpy(bad)}).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)
    lp = TF.MultivariateNormal.log_prob(torch.zeros(2), {"loc": torch.zeros(2),
                                                         "covariance_matrix": torch.from_numpy(bad)})
    assert torch.isnan(lp)
    good = np.stack([bad, _COV.astype(np.float32)])
    L = TF.MultivariateNormal._chol({"covariance_matrix": torch.from_numpy(good)}).numpy()
    assert np.isnan(L[0]).any() and np.allclose(L[1], np.linalg.cholesky(_COV), atol=1e-6)


def test_mvn_precision_and_scale_tril():
    """From a precision matrix the port's density is scipy's (1e-4);
    ``alan_tpu`` solves with the transposed inverse of the precision's
    factor as if it were lower triangular, which reads its diagonal only:
    its density differs where the precision is not diagonal.  From a
    ``scale_tril`` both packages agree (1e-5)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 3))
    S = A @ A.T + np.eye(3)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    loc = np.zeros(3, np.float32)
    prec = np.linalg.inv(S).astype(np.float32)
    theirs = st.multivariate_normal(loc, S).logpdf(x)
    got = TF.MultivariateNormal.log_prob(torch.from_numpy(x), {
        "loc": torch.from_numpy(loc), "precision_matrix": torch.from_numpy(prec)})
    np.testing.assert_allclose(got.numpy(), theirs, rtol=1e-4, atol=1e-4)
    jax_lp = np.asarray(JF.MultivariateNormal.log_prob(
        jnp.asarray(x), {"loc": jnp.asarray(loc), "precision_matrix": jnp.asarray(prec)}))
    assert np.abs(jax_lp - theirs).max() > 1e-2
    tril = np.linalg.cholesky(S).astype(np.float32)
    want = np.asarray(JF.MultivariateNormal.log_prob(
        jnp.asarray(x), {"loc": jnp.asarray(loc), "scale_tril": jnp.asarray(tril)}))
    got = TF.MultivariateNormal.log_prob(torch.from_numpy(x), {
        "loc": torch.from_numpy(loc), "scale_tril": torch.from_numpy(tril)})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the draws from a precision have the covariance
    d = TF.MultivariateNormal.sample(torch.Generator().manual_seed(0), (N, 3),
                                     {"loc": torch.from_numpy(loc),
                                      "precision_matrix": torch.from_numpy(prec)})
    np.testing.assert_allclose(np.cov(d.numpy().T), S, atol=0.1)


# ---- VI through a Gamma latent ------------------------------------------------------------

def test_vi_gradient_on_a_gamma_latent_matches_jax():
    """A Gamma latent with a Gamma Q of opt params (log-concentration and
    log-rate) and Poisson counts: the VI ELBO and its gradient with respect
    to Q's opt params from ``alan_tpu``'s draws, whose standard noise is the
    standard gamma draw (the draw times Q's rate): ELBO 1e-5 relative,
    gradients rtol/atol 1e-4.  The gradient reaches the concentration only
    through the implicit gradient of the gamma draw."""
    from alan_tpu import (BoundPlate as JBP, Data as JData, Gamma as JGamma,
                          OptParam as JOpt, Plate as JPlate, Poisson as JPoisson,
                          Problem as JProblem, named as jnamed, train as jtrain)
    from alan_tpu.sampler import PermutationSampler as JPerm
    from alan_tpu_torch import (BoundPlate, Data, Gamma, OptParam, Plate, Poisson,
                                Problem, named, train)
    from alan_tpu_torch.dims import DT
    counts = np.array([3, 5, 2, 4, 6, 3, 1, 4], np.float32)
    ps, K, key = {"T": len(counts)}, 20, jax.random.key(5)
    jP = JPlate(a=JGamma(2.0, 1.0), T=JPlate(d=JPoisson("a")))
    jQ = JPlate(a=JGamma(JOpt(math.log(3.0), transformation=jnp.exp),
                         JOpt(math.log(0.8), transformation=jnp.exp)), T=JPlate(d=JData()))
    jprob = JProblem(JBP(jP, ps), JBP(jQ, ps), {"d": jnamed(jnp.asarray(counts), "T")})
    tP = Plate(a=Gamma(2.0, 1.0), T=Plate(d=Poisson("a")))
    tQ = Plate(a=Gamma(OptParam(math.log(3.0), transformation=torch.exp),
                       OptParam(math.log(0.8), transformation=torch.exp)), T=Plate(d=Data()))
    tprob = Problem(BoundPlate(tP, ps, device="cpu"), BoundPlate(tQ, ps, device="cpu"),
                    {"d": named(torch.from_numpy(counts), "T")}, device="cpu")

    stP, stQ = jprob.P.state(), jprob.Q.state()
    f = jtrain.elbo_fn(jprob, K, True)
    j_elbo, j_grads = jax.value_and_grad(lambda q: f(stP, {**stQ, "opt": q}, key))(stQ["opt"])
    jtree, _ = jprob.Q._sample(K, True, JPerm, jprob.all_platedims, key, state=stQ)
    a = np.asarray(jtree["a"].data)
    rate = float(np.asarray(jprob.Q.opt_params(stQ)["a_rate"].data))
    noise = {"a": DT(torch.from_numpy(a * rate), jtree["a"].dims), "T": {}}

    g = train.elbo_fn(tprob, K, True)
    leaves, sP, sQ = train.opt_leaves(tprob.P.state(), tprob.Q.state())
    t_elbo = g(sP, sQ, noise=noise)
    t_grads = dict(zip([*sP["opt"], *sQ["opt"]], torch.autograd.grad(t_elbo, leaves)))
    t_elbo = t_elbo.detach()
    assert abs(float(t_elbo) - float(j_elbo)) <= 1e-5 * abs(float(j_elbo))
    assert set(t_grads) == set(j_grads) == {"a_concentration", "a_rate"}
    for k, v in j_grads.items():
        np.testing.assert_allclose(t_grads[k].numpy(), np.asarray(v.data), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert abs(float(t_grads["a_concentration"])) > 1e-3


@pytest.mark.parametrize("q", ["MultivariateNormal", "Dirichlet"])
def test_support_check_compares_the_new_tokens(q):
    """P/Q support checking reads each family's token: a factorised Normal
    prior (``real``) against a MultivariateNormal proposal
    (``real_vector``), or a Dirichlet (``simplex``) against a
    RelaxedOneHotCategorical (also ``simplex``), raises or passes in the
    port as in ``alan_tpu``."""
    import alan_tpu as J
    import alan_tpu_torch as T
    outcomes = []
    for pkg, arr, kw in ((J, jnp.asarray, {}), (T, torch.tensor, {"device": "cpu"})):
        if q == "MultivariateNormal":
            P = pkg.Plate(a=pkg.Normal(0.0, 1.0, sample_shape=[3]), d=pkg.Normal(
                lambda a: a.sum(), 1.0))
            Q = pkg.Plate(a=pkg.MultivariateNormal(arr(np.zeros(3, np.float32)),
                                                   arr(np.eye(3, dtype=np.float32))),
                          d=pkg.Data())
        else:
            P = pkg.Plate(a=pkg.Dirichlet(arr(np.ones(3, np.float32))),
                          d=pkg.Normal(lambda a: a.sum(), 1.0))
            Q = pkg.Plate(a=pkg.RelaxedOneHotCategorical(
                0.5, probs=arr(np.full(3, 1 / 3, np.float32))), d=pkg.Data())
        try:
            pkg.Problem(pkg.BoundPlate(P, {}, **kw), pkg.BoundPlate(Q, {}, **kw),
                        {"d": arr(np.float32(1.0))}, **kw)
            outcomes.append("ok")
        except Exception as e:   # the same message in both packages
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert ("different support" in outcomes[0]) == (q == "MultivariateNormal")
