"""The analytic zoo in the port: the counterparts of eleven models of
``tests/model_*.py`` (beside the two that ``tests/test_torch_posterior.py``
carries) under the oracles of ``tests/test_problem_vs_itself.py:87-166``.

The models are built here from the same numpy seeds as their ``alan_tpu``
files, and their ground truths (posterior moments, log-evidence) computed
here in numpy and scipy; the oracles are analytic, so no case runs JAX.

* ``test_moments_sample_marginal``: ``Sample.moments`` equal
  ``marginals().moments`` (rtol 1e-4, atol 1e-5) at K=3 (:87-96);
* ``test_moments_importance_sample``: the moments of N importance samples
  within 6 standard errors of the marginals' (:99-116);
* ``test_moments_ground_truth``: the marginals' moments within 7 standard
  errors (at the marginals' smallest ESS) of the analytic ones (:119-136);
* ``test_elbo_ground_truth``: ELBO draws bracket the analytic log-evidence,
  within the model's gap (:139-160);
* ``test_moments_vs_moments``: the moments of two samples, one of them
  reparameterised or drawn by another sampler, within 6 combined standard
  errors (:163-176);
* ``test_compute_strategy``: the compute-strategy oracles (:179-221) at
  K=3: ``elbo_vi`` under ``checkpoint`` and ``no_checkpoint`` against
  ``no_checkpoint`` and the model's own strategy (its ``Split`` in
  ``tests/model_*.py``, else ``no_checkpoint``), ``elbo_rws`` and the
  marginals' moments under each against the model's own strategy (ELBOs
  rtol 1e-5 / atol 1e-6, moments ``allclose_dt``'s rtol 1e-4 / atol
  1e-5).

Each model takes one sampler and reparameterisation (in turn over the
models); ``bernoulli_no_plate`` and ``linear_multivariate_gaussian_param``
take the whole grid.  The importance samples of a model with two latents
at its root at K = 1000 replay one categorical over K^2 joint particles for
each of N = 1000 draws (1e9 Gumbel variates, ~12 s on a host core), as
``alan_tpu`` does; the grid is run on the two models without one.
"""
import itertools
import math
import zlib

import numpy as np
import pytest
import scipy.stats as st
import torch

from alan_tpu_torch import (Bernoulli, Beta, BoundPlate, CategoricalSampler, Data,
                            Group, MultivariateNormal, Normal, OptParam,
                            PermutationSampler, Plate, Problem, QEMParam, Split,
                            checkpoint, named, no_checkpoint, samplers)
from alan_tpu_torch import moments as tm
from test_torch_harness import port_np


class Zoo:
    """One model: its P, Q and data, and ``tests/testproblem.py``'s
    settings."""

    def __init__(self, P, Q, data, platesizes, moments, known_moments=None,
                 known_elbo=None, moment_K=30, elbo_K=30, elbo_iters=20,
                 elbo_gap_cat=1, elbo_gap_perm=1, importance_N=1000,
                 extra_opt_params=None, computation_strategy=no_checkpoint):
        self.problem = Problem(
            BoundPlate(P, platesizes, device="cpu"),
            BoundPlate(Q, platesizes, extra_opt_params=extra_opt_params, device="cpu"),
            data, device="cpu")
        self.moments = moments
        self.known_moments = known_moments or {}
        self.known_elbo = known_elbo
        self.moment_K, self.elbo_K, self.elbo_iters = moment_K, elbo_K, elbo_iters
        self.elbo_gap_cat, self.elbo_gap_perm = elbo_gap_cat, elbo_gap_perm
        self.importance_N = importance_N
        self.computation_strategy = computation_strategy


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _gaussian_elbo(data, mean, cov):
    return float(st.multivariate_normal.logpdf(data, mean, cov))


def model1():
    P = Plate(a=Normal(0, 1), b=Normal("a", 1), c=Normal(0, lambda a: a.exp()),
              p1=Plate(d=Normal("a", 1), p2=Plate(e=Normal("d", 1.))))
    Q = Plate(ab=Group(a=Normal(QEMParam(0.), QEMParam(1.)), b=Normal("a", 1)),
              c=Normal(0, lambda a: a.exp()),
              p1=Plate(d=Normal(OptParam(0.), "d_scale"), p2=Plate(e=Data())))
    data = np.random.default_rng(11).standard_normal((4, 4))
    return Zoo(P, Q, {"e": named(_t(data), "p1", "p2")}, {"p1": 4, "p2": 4},
               [("a", tm.mean), ("b", tm.mean), ("c", tm.mean), ("d", tm.mean)],
               moment_K=1000, extra_opt_params={"d_scale": named(torch.ones(4), "p1")},
               computation_strategy=Split("p1", 3))


def bernoulli_no_plate():
    P = Plate(p=Beta(2, 1), T=Plate(coin=Bernoulli("p")))
    Q = Plate(p=Beta(1, 1), T=Plate(coin=Data()))
    data = np.concatenate([np.zeros(3), np.ones(7)])
    return Zoo(P, Q, {"coin": named(_t(data), "T")}, {"T": 10}, [("p", tm.mean)],
               known_moments={("p", tm.mean): (7 + 2) / (2 + 1 + 10)}, moment_K=10000,
               computation_strategy=Split("T", 4))


def _two_params(seed, a_scale, b_scale, q_b, q_a=None, split=no_checkpoint):
    """``linear_gaussian_two_params`` and its corr_Q variants: a -> b -> d."""
    prior_mean, like_scale, N = 2, 3, 10
    prior_var = a_scale ** 2 + b_scale ** 2
    data = 1.5 + np.random.default_rng(seed).standard_normal(N)
    post_prec = 1 / prior_var + N / like_scale ** 2
    post_mean = (prior_mean / prior_var + data.sum() / like_scale ** 2) / post_prec
    known_elbo = _gaussian_elbo(data, prior_mean * np.ones(N),
                                prior_var * np.ones((N, N)) + like_scale ** 2 * np.eye(N))
    P = Plate(a=Normal(prior_mean, a_scale), b=Normal("a", b_scale),
              T=Plate(d=Normal("b", like_scale)))
    Q = Plate(**(q_a or {}), **q_b, T=Plate(d=Data()))
    return Zoo(P, Q, {"d": named(_t(data), "T")}, {"T": N},
               [("a", tm.mean), ("a", tm.mean2), ("b", tm.mean), ("b", tm.mean2)],
               known_moments={("b", tm.mean): post_mean,
                              ("b", tm.mean2): post_mean ** 2 + 1 / post_prec},
               known_elbo=known_elbo, moment_K=1000, elbo_K=1000,
               computation_strategy=split)


def linear_gaussian_two_params():
    return _two_params(1, 0.1, 1, {"b": Normal(1, 4)}, {"a": Normal(1, 4)},
                       Split("T", 5))


def linear_gaussian_two_params_corr_Q():
    return _two_params(2, 1, 1, {"b": Normal("a", 1.2)}, {"a": Normal(1, 4)},
                       Split("T", 5))


def linear_gaussian_two_params_corr_Q_reversed():
    return _two_params(3, 1, 1, {"a": Normal("b", 1.2)}, {"b": Normal(1, 4)})


def linear_gaussian_two_params_dangling():
    prior_mean, prior_scale, like_scale, mult, N = 2, 2, 3, 2.5, 10
    data = 1.5 + np.random.default_rng(4).standard_normal(N)
    post_prec = 1 / prior_scale ** 2 + N * mult ** 2 / like_scale ** 2
    post_mean = (prior_mean / prior_scale ** 2
                 + mult ** 2 / like_scale ** 2 * (data.sum() / mult)) / post_prec
    known_elbo = _gaussian_elbo(data, prior_mean * mult * np.ones(N),
                                (mult * prior_scale) ** 2 * np.ones((N, N))
                                + like_scale ** 2 * np.eye(N))
    P = Plate(a=Normal(prior_mean, prior_scale), b=Normal("a", 1.3),
              T=Plate(d=Normal(lambda a: mult * a, like_scale)))
    Q = Plate(a=Normal(1, 4), b=Normal(lambda a: 1.2 * a, 1.2), T=Plate(d=Data()))
    return Zoo(P, Q, {"d": named(_t(data), "T")}, {"T": N},
               [("a", tm.mean), ("a", tm.mean2), ("b", tm.mean), ("b", tm.mean2)],
               known_moments={("a", tm.mean): post_mean,
                              ("a", tm.mean2): post_mean ** 2 + 1 / post_prec,
                              ("b", tm.mean): post_mean,
                              ("b", tm.mean2): post_mean ** 2 + 1 / post_prec + 1.3 ** 2},
               known_elbo=known_elbo, moment_K=1000, elbo_K=1000)


def linear_gaussian_latents_dangling():
    prior_mean, prior_scale, z_scale, d_scale, N = 2, 2, 1.3, 1.5, 10
    like_var = z_scale ** 2 + d_scale ** 2
    data = 1.5 + np.random.default_rng(6).standard_normal(N)
    post_prec = 1 / prior_scale ** 2 + N / like_var
    post_mean = (prior_mean / prior_scale ** 2 + data.sum() / like_var) / post_prec
    known_elbo = _gaussian_elbo(data, prior_mean * np.ones(N),
                                prior_scale ** 2 * np.ones((N, N)) + like_var * np.eye(N))
    P = Plate(a=Normal(prior_mean, prior_scale),
              T=Plate(z=Normal("a", z_scale), zp=Normal("a", 1.), d=Normal("z", d_scale)))
    Q = Plate(a=Normal(1, 4),
              T=Plate(z=Normal(lambda a: 1.5 * a, 3.5), zp=Normal(lambda a: 1.5 * a, 3.5),
                      d=Data()))
    return Zoo(P, Q, {"d": named(_t(data), "T")}, {"T": N},
               [("a", tm.mean), ("a", tm.mean2), ("z", tm.mean), ("z", tm.mean2)],
               known_moments={("a", tm.mean): post_mean,
                              ("a", tm.mean2): post_mean ** 2 + 1 / post_prec},
               known_elbo=known_elbo, moment_K=100, elbo_K=1000, elbo_iters=30,
               elbo_gap_cat=2, computation_strategy=Split("T", 5))


def linear_gaussian_latents_batch():
    rng = np.random.default_rng(7)
    prior_mean = rng.standard_normal(2).astype(np.float32)
    prior_scale, z_scale, d_scale = np.array([1., 2.]), np.array([1.3, 1.6]), np.array([2., 3.])
    like_var = z_scale ** 2 + d_scale ** 2
    N = 10
    data = 1.5 + rng.standard_normal((N, 2)).astype(np.float32)
    post_prec = 1 / prior_scale ** 2 + N / like_var
    post_mean = (prior_mean / prior_scale ** 2 + data.sum(0) / like_var) / post_prec
    P = Plate(a=Normal(_t(prior_mean), _t(prior_scale)),
              T=Plate(z=Normal("a", _t(z_scale)), d=Normal("z", _t(d_scale))))
    Q = Plate(a=Normal(torch.zeros(2), 4), T=Plate(z=Normal(lambda a: 0.5 * a, 6), d=Data()))
    return Zoo(P, Q, {"d": named(_t(data), "T")}, {"T": N},
               [("a", tm.mean), ("a", tm.mean2), ("z", tm.mean), ("z", tm.mean2)],
               known_moments={("a", tm.mean): post_mean,
                              ("a", tm.mean2): post_mean ** 2 + 1 / post_prec},
               moment_K=1000, computation_strategy=Split("T", 3))


def linear_multivariate_gaussian():
    F = 2
    rng = np.random.default_rng(8)
    prior_mean = rng.standard_normal(F).astype(np.float32)
    A = rng.standard_normal((F, F)).astype(np.float32)
    prior_cov = A @ A.T
    ap_mean = rng.standard_normal(F).astype(np.float32)
    B = rng.standard_normal((F, F)).astype(np.float32)
    ap_cov = B @ B.T + 2 * np.eye(F, dtype=np.float32)
    C = rng.standard_normal((F, F)).astype(np.float32)
    like_cov = C @ C.T
    data = (1.5 + rng.standard_normal(F)).astype(np.float32)
    post_cov = np.linalg.inv(np.linalg.inv(prior_cov) + np.linalg.inv(like_cov))
    post_mean = post_cov @ (np.linalg.solve(prior_cov, prior_mean)
                            + np.linalg.solve(like_cov, data))
    known_elbo = _gaussian_elbo(data.astype(np.float64), prior_mean, prior_cov + like_cov)
    P = Plate(a=MultivariateNormal(_t(prior_mean), _t(prior_cov)),
              d=MultivariateNormal("a", _t(like_cov)))
    Q = Plate(a=MultivariateNormal(_t(ap_mean), _t(ap_cov)), d=Data())
    return Zoo(P, Q, {"d": _t(data)}, {}, [("a", tm.mean)],
               known_moments={("a", tm.mean): post_mean}, known_elbo=known_elbo,
               moment_K=10000, elbo_K=1000)


def linear_multivariate_gaussian_batch():
    N, F = 3, 2
    rng = np.random.default_rng(9)
    prior_mean = rng.standard_normal((N, F)).astype(np.float32)
    A = rng.standard_normal((N, F, F)).astype(np.float32)
    prior_cov = A @ np.swapaxes(A, -1, -2)
    ap_mean = prior_mean + 0.5 * rng.standard_normal((N, F)).astype(np.float32)
    ap_cov = prior_cov + 2 * np.eye(F, dtype=np.float32)
    C = rng.standard_normal((N, F, F)).astype(np.float32)
    like_cov = C @ np.swapaxes(C, -1, -2)
    data = (1.5 + rng.standard_normal((N, F))).astype(np.float32)
    post_cov = np.linalg.inv(np.linalg.inv(prior_cov) + np.linalg.inv(like_cov))
    post_mean = (post_cov @ (np.linalg.inv(prior_cov) @ prior_mean[..., None]
                             + np.linalg.inv(like_cov) @ data[..., None]))[..., 0]
    P = Plate(a=MultivariateNormal(_t(prior_mean), _t(prior_cov)),
              d=MultivariateNormal("a", _t(like_cov)))
    Q = Plate(a=MultivariateNormal(_t(ap_mean), _t(ap_cov)), d=Data())
    return Zoo(P, Q, {"d": _t(data)}, {}, [("a", tm.mean)],
               known_moments={("a", tm.mean): post_mean}, moment_K=10000)


def linear_multivariate_gaussian_param():
    F, N = 2, 10
    rng = np.random.default_rng(10)
    prior_mean = rng.standard_normal(F).astype(np.float32)
    A = rng.standard_normal((F, F)).astype(np.float32)
    prior_cov = A @ A.T
    ap_mean = rng.standard_normal(F).astype(np.float32)
    B = rng.standard_normal((F, F)).astype(np.float32)
    ap_cov = B @ B.T + 4 * np.eye(F, dtype=np.float32)
    C = rng.standard_normal((F, F)).astype(np.float32)
    like_cov = C @ C.T
    data = (1.5 + rng.standard_normal((N, F))).astype(np.float32)
    post_cov = np.linalg.inv(np.linalg.inv(prior_cov) + N * np.linalg.inv(like_cov))
    post_mean = post_cov @ (np.linalg.solve(prior_cov, prior_mean)
                            + np.linalg.solve(like_cov, data.sum(0)))
    P = Plate(a=MultivariateNormal(_t(prior_mean), _t(prior_cov)),
              T=Plate(d=MultivariateNormal("a", _t(like_cov))))
    Q = Plate(a=MultivariateNormal(_t(ap_mean), _t(ap_cov)), T=Plate(d=Data()))
    return Zoo(P, Q, {"d": named(_t(data), "T")}, {"T": N}, [("a", tm.mean)],
               known_moments={("a", tm.mean): post_mean}, moment_K=10000)


ZOO = {f.__name__: f for f in [
    model1, bernoulli_no_plate, linear_gaussian_two_params,
    linear_gaussian_two_params_corr_Q, linear_gaussian_two_params_corr_Q_reversed,
    linear_gaussian_two_params_dangling, linear_gaussian_latents_dangling,
    linear_gaussian_latents_batch, linear_multivariate_gaussian,
    linear_multivariate_gaussian_batch, linear_multivariate_gaussian_param]}
#: the models that take every sampler and reparameterisation
FULL_GRID = ("bernoulli_no_plate", "linear_multivariate_gaussian_param")
_COMBOS = list(itertools.product([True, False], samplers))


#: the models that state analytic moments, and an analytic log-evidence
KNOWN_MOMENTS = tuple(n for n in ZOO if n != "model1")
KNOWN_ELBO = ("linear_gaussian_two_params", "linear_gaussian_two_params_corr_Q",
              "linear_gaussian_two_params_corr_Q_reversed",
              "linear_gaussian_two_params_dangling", "linear_gaussian_latents_dangling",
              "linear_multivariate_gaussian")


def _cases(with_reparam=True, only=tuple(ZOO)):
    out = []
    for i, name in enumerate(ZOO):
        if name not in only:
            continue
        combos = _COMBOS if name in FULL_GRID else [_COMBOS[i % len(_COMBOS)]]
        if not with_reparam:
            combos = list(dict.fromkeys((False, s) for _, s in combos))
        out += [(name, r, s) if with_reparam else (name, s) for r, s in combos]
    return out


_BUILT = {}


def zoo(name) -> Zoo:
    if name not in _BUILT:
        _BUILT[name] = ZOO[name]()
    return _BUILT[name]


def _gen(*salt):
    return torch.Generator().manual_seed(zlib.crc32(repr(salt).encode()))


def _np(x, dims):
    return port_np(x, dims) if hasattr(x, "dims") else np.asarray(x, np.float64)


def _within(value, lo, hi, dims):
    v, l, h = _np(value, dims), _np(lo, dims), _np(hi, dims)
    assert np.all(l < v) and np.all(v < h), (l, v, h)


def _stderr(marg, varnames, m, n):
    """The marginal moment and its standard error at ``n`` samples."""
    return (marg.moments(varnames, m),
            (marg.moments(varnames, tm.var_from_raw_moment(m)) / float(n)).sqrt())


@pytest.mark.parametrize("tp_name,reparam,sampler", _cases())
def test_moments_sample_marginal(tp_name, reparam, sampler):
    tp = zoo(tp_name)
    sample = tp.problem.sample(3, _gen(tp_name, 1), reparam=reparam, sampler=sampler)
    marginals = sample.marginals()
    for varnames, moment in tp.moments:
        sm = sample.moments(varnames, moment)
        mm = marginals.moments(varnames, moment)
        assert set(sm.dims) == set(mm.dims)
        np.testing.assert_allclose(port_np(sm, sm.dims), port_np(mm, sm.dims),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tp_name,reparam,sampler", _cases())
def test_moments_importance_sample(tp_name, reparam, sampler):
    tp = zoo(tp_name)
    gen = _gen(tp_name, 2, reparam)
    sample = tp.problem.sample(tp.moment_K, gen, reparam=reparam, sampler=sampler)
    marginals = sample.marginals()
    isamp = sample.importance_sample(tp.importance_N, gen)
    for varnames, m in tp.moments:
        mm, stderr = _stderr(marginals, varnames, m, tp.importance_N)
        im = isamp.moments(varnames, m)
        _within(im, mm - 6 * stderr, mm + 6 * stderr, im.dims)


@pytest.mark.parametrize("tp_name,sampler", _cases(False, KNOWN_MOMENTS))
def test_moments_ground_truth(tp_name, sampler):
    tp = zoo(tp_name)
    sample = tp.problem.sample(tp.moment_K, _gen(tp_name, 3), reparam=False,
                               sampler=sampler)
    marginals = sample.marginals()
    min_ess = float(marginals.min_ess())
    for (varnames, m), true in tp.known_moments.items():
        mm, stderr = _stderr(marginals, (varnames,) if isinstance(varnames, str)
                             else varnames, m, min_ess)
        true = np.broadcast_to(np.asarray(true, np.float64), port_np(mm, mm.dims).shape)
        _within(true, mm - 7 * stderr, mm + 7 * stderr, mm.dims)


@pytest.mark.parametrize("tp_name,sampler", _cases(False, KNOWN_ELBO))
def test_elbo_ground_truth(tp_name, sampler):
    tp = zoo(tp_name)
    gen = _gen(tp_name, 4)
    e = np.array([float(tp.problem.sample(tp.elbo_K, gen, reparam=False,
                                          sampler=sampler).elbo_nograd())
                  for _ in range(tp.elbo_iters)])
    n = tp.elbo_iters
    sample_mean, sample_var = e.mean(), e.var(ddof=1)
    se_mean = np.sqrt(sample_var / n)
    max_var = sample_var + 6 * np.sqrt(2 * sample_var ** 2 / n)
    max_elbo = sample_mean + 6 * se_mean + max_var / 2
    min_elbo = sample_mean - 6 * se_mean
    assert min_elbo < tp.known_elbo < max_elbo, (min_elbo, tp.known_elbo, max_elbo)
    gap = tp.elbo_gap_cat if sampler is CategoricalSampler else tp.elbo_gap_perm
    assert max_elbo - min_elbo < gap


@pytest.mark.parametrize("tp_name,reparam,sampler", _cases())
def test_moments_vs_moments(tp_name, reparam, sampler):
    tp = zoo(tp_name)
    base = tp.problem.sample(tp.moment_K, _gen(tp_name, 5), reparam=False,
                             sampler=PermutationSampler).marginals()
    test = tp.problem.sample(tp.moment_K, _gen(tp_name, 6, reparam), reparam=reparam,
                             sampler=sampler).marginals()
    for varnames, moment in tp.moments:
        bm, bs = _stderr(base, varnames, moment, float(base.min_ess()))
        tm_, ts = _stderr(test, varnames, moment, float(test.min_ess()))
        stderr = (bs * bs + ts * ts).sqrt()
        _within(bm - tm_, -6 * stderr, 6 * stderr, bm.dims)


def test_zoo_covers_the_non_timeseries_models():
    """The port's zoo: these eleven and the two of
    ``tests/test_torch_posterior.py`` are the thirteen non-timeseries models
    of ``tests/test_problem_vs_itself.py``."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    models = {f[len("model_"):-3] for f in os.listdir(root)
              if f.startswith("model_") and f.endswith(".py") and "timeseries" not in f}
    assert models == set(ZOO) | {"linear_gaussian", "linear_gaussian_latents"}
    assert set(KNOWN_MOMENTS) == {n for n in ZOO if zoo(n).known_moments}
    assert set(KNOWN_ELBO) == {n for n in ZOO if zoo(n).known_elbo is not None}
    assert math.isclose(zoo("bernoulli_no_plate").known_moments[("p", tm.mean)], 9 / 13)


def _allclose_dt(a, b):
    assert set(a.dims) == set(b.dims)
    np.testing.assert_allclose(port_np(a, a.dims), port_np(b, a.dims), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tp_name,oracle,compstrat", [
    (n, o, c) for n in ZOO for o in ("elbo_vi", "elbo_rws", "moments")
    for c in ("checkpoint", "no_checkpoint")])
def test_compute_strategy(tp_name, oracle, compstrat):
    """``tests/test_problem_vs_itself.py:179-221``: every strategy, the
    model's ``Split`` among them, gives the same ELBO and moments."""
    tp = zoo(tp_name)
    cs = {"checkpoint": checkpoint, "no_checkpoint": no_checkpoint}[compstrat]
    own = tp.computation_strategy
    sample = tp.problem.sample(3, _gen(tp_name, 7, oracle), reparam=oracle == "elbo_vi",
                               sampler=PermutationSampler)
    close = lambda a, b: np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-6)
    if oracle == "elbo_vi":
        base = sample.elbo_vi(computation_strategy=no_checkpoint)
        close(sample.elbo_vi(computation_strategy=cs), base)
        close(sample.elbo_vi(computation_strategy=own), base)
    elif oracle == "elbo_rws":
        close(sample.elbo_rws(computation_strategy=cs),
              sample.elbo_rws(computation_strategy=own))
    else:
        base = sample.marginals(computation_strategy=own)
        test = sample.marginals(computation_strategy=cs)
        for varnames, moment in tp.moments:
            _allclose_dt(base.moments(varnames, moment), test.moments(varnames, moment))
