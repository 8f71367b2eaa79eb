"""The port's gold samplers (``alan_tpu_torch/mcmc.py``, ``nuts.py``,
``smc.py``) and diagnostics against ``alan_tpu``'s, on the CPU.

* ``log_joint`` and ``make_logpost``, value and gradient at the same theta
  (the same layout: ``alan_tpu``'s theta0 rebuilt around the port's prior
  draw), on the linear Gaussian, the Dirichlet-Categorical, the
  LKJ model of ``tests/test_mcmc_smc.py`` and covid at 4 x 16: values rtol
  1e-5, gradients rtol 1e-4 (atol 1e-4 of the largest entry);
* each unconstraining transform and its inverse: 1e-5;
* short whole runs on the linear Gaussian given ``alan_tpu``'s noise,
  re-derived from its key tree with ``jax.random`` (``mcmc.py:288-345``,
  ``nuts.py:134-233``, ``smc.py:86-140``; draws inside a ``vmap`` cannot be
  recorded): ``run_hmc`` (2 chains, 3 warmup and 3 draws, 4 leapfrog steps)
  and ``run_nuts`` (max_depth 3) draws and step size within 1e-4,
  ``run_smc`` (64 particles) the same stages and lambdas, particles within
  1e-4 and log Z within 1e-4;
* the samplers run in the data's float dtype;
* ``diagnostics`` equal to ``alan_tpu``'s on the same numpy draws (rtol
  1e-6).

``tests/test_mcmc_smc.py``'s oracles take ~15 s (HMC) and ~75 s (NUTS) on
a host core here: they run on the card (``chip_smoke.py``'s
``gold_analytic``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import model_linear_gaussian as jm
from alan_tpu import BoundPlate as JBoundPlate
from alan_tpu import Categorical as JCategorical
from alan_tpu import Dirichlet as JDirichlet
from alan_tpu import LKJCholesky as JLKJ
from alan_tpu import MultivariateNormal as JMVN
from alan_tpu import Plate as JPlate
from alan_tpu import diagnostics as jdiag
from alan_tpu import mcmc as jmcmc
from alan_tpu import named as jnamed
from alan_tpu.dims import DT as JDT
from alan_tpu.nuts import run_nuts as j_run_nuts
from alan_tpu.smc import run_smc as j_run_smc
from alan_tpu_torch import (BoundPlate, Categorical, Dirichlet, LKJCholesky,
                            MultivariateNormal, Normal, Plate, convert, named)
from alan_tpu_torch import diagnostics as tdiag
from alan_tpu_torch import mcmc as tmcmc
from alan_tpu_torch.dims import DT
from alan_tpu_torch.models import covid as tcovid
from alan_tpu_torch.nuts import run_nuts
from alan_tpu_torch.smc import run_smc
from test_torch_harness import to_numpy_tree


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# ---- the models in both packages ----------------------------------------------

def linear_gaussian():
    P = BoundPlate(Plate(a=Normal(jm.prior_mean, jm.prior_scale),
                         T=Plate(d=Normal(lambda a: jm.mult * a, jm.like_scale))),
                   {"T": jm.N}, device="cpu")
    return jm.P, jm.data, P, {"d": named(_t(jm.data_np), "T")}


COUNTS = np.array([0, 0, 1, 1, 1, 2, 2, 2, 2, 2], np.float32)


def dirichlet_categorical():
    jP = JBoundPlate(JPlate(p=JDirichlet(jnp.ones(3)), T=JPlate(c=JCategorical(probs="p"))),
                     {"T": 10})
    P = BoundPlate(Plate(p=Dirichlet(torch.ones(3)), T=Plate(c=Categorical(probs="p"))),
                   {"T": 10}, device="cpu")
    return (jP, {"c": jnamed(jnp.asarray(COUNTS), "T")}, P,
            {"c": named(torch.tensor(COUNTS), "T")})


def lkj():
    rng = np.random.default_rng(0)
    true_L = np.linalg.cholesky(np.array([[1., .7], [.7, 1.]]))
    obs = (rng.standard_normal((20, 2)) @ true_L.T).astype(np.float32)
    jP = JBoundPlate(JPlate(L=JLKJ(2, 2.0),
                            T=JPlate(y=JMVN(jnp.zeros(2), scale_tril="L"))), {"T": 20})
    P = BoundPlate(Plate(L=LKJCholesky(2, 2.0),
                         T=Plate(y=MultivariateNormal(torch.zeros(2), scale_tril="L"))),
                   {"T": 20}, device="cpu")
    return jP, {"y": jnamed(jnp.asarray(obs), "T")}, P, {"y": named(_t(obs), "T")}


def covid():
    """Covid at 4 regions x 16 training days, counts of a few hundred
    (``tests/test_torch_timeseries.py``'s setup), both packages' P."""
    import covid as jcovid
    arrays = tcovid.fake_data(seed=4, nRs=4, nDs=20)
    arrays["obs"] = np.random.default_rng(4).poisson(300.0, (4, 20)).astype(np.float32)
    nm, ps = ("nRs", "nDs"), {"nRs": 4, "nDs": 16}
    names = {"ActiveCMs_NPIs": "npis", "ActiveCMs_wearing": "wearing",
             "ActiveCMs_mobility": "mobility"}
    jcut = lambda a: jnamed(jnp.asarray(a[:, :16]), *nm)
    cut = lambda a: convert.dt_from_numpy(a[:, :16], nm, "cpu")
    jP = jcovid.get_P(ps, {k: jcut(arrays[v]) for k, v in names.items()})
    P = tcovid.get_P(ps, {k: cut(arrays[v]) for k, v in names.items()}, device="cpu")
    return jP, {"obs": jcut(arrays["obs"])}, P, {"obs": cut(arrays["obs"])}


MODELS = {"linear_gaussian": linear_gaussian,
          "dirichlet_categorical": dirichlet_categorical, "lkj": lkj, "covid": covid}


def _start(jP, jdata):
    """``alan_tpu``'s starting latents (its prior draw at key 0), as numpy
    and as the port's DTs."""
    lat = jax.jit(lambda key: jmcmc._init_from_prior(jP, jdata, key))(jax.random.key(0))
    return convert.tree_from_numpy(to_numpy_tree(lat), "cpu")


def _port_start(P, data):
    """The port's prior draw (seed 0) of every latent, the start that
    ``alan_tpu``'s log posterior is rebuilt around."""
    lat = P.sample(torch.Generator().manual_seed(0))
    return {k: v for k, v in lat.items() if k not in data}


# ---- log joint and log posterior ----------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_logpost_matches_jax(name):
    jP, jdata, P, data = MODELS[name]()
    latents = _port_start(P, data)
    if name == "covid":
        # a start where the counts' NegativeBinomial is not within an ulp of
        # its edge (a prior draw's log_infected reaches e^39)
        dims = latents["log_infected"].dims
        latents["log_infected"] = DT(torch.log(data["obs"].with_dims_front(dims).data
                                               + 1.0), dims)
    jlatents = {k: JDT(jnp.asarray(v.data.numpy()), v.dims) for k, v in latents.items()}
    jlogpost, jtheta0, _, _ = jmcmc.make_logpost(jP, jdata)
    # alan_tpu's make_logpost starts from its own prior draw: rebuild its
    # theta0 from the (possibly replaced) latents, in its ravel layout
    u0 = {}
    for nm, tr in {n: t for n, _, t in jmcmc._latent_specs(jP, jdata)}.items():
        v = jlatents[nm].data
        u0[nm] = (jnp.log(jnp.clip(v, min=1e-6)) if tr == "exp" else
                  jmcmc._stickbreak_inv(v) if tr == "stickbreak" else
                  jmcmc._corrchol_inv(v) if tr == "corrchol" else v)
    jtheta0, _ = ravel_pytree(u0)
    logpost, theta0, _, _ = tmcmc.make_logpost(P, data, latents=latents)
    np.testing.assert_allclose(theta0.numpy(), np.asarray(jtheta0), rtol=1e-6, atol=1e-6)

    rng = np.random.default_rng(1)
    thetas = np.asarray(jtheta0)[None] + 0.05 * rng.standard_normal(
        (3, theta0.numel())).astype(np.float32)
    thetas[0] = np.asarray(jtheta0)
    # one compilation: the log posterior's values and gradients, and
    # log_joint at the starting latents
    (jv, jg), jlj = jax.jit(lambda th, lat: (jax.vmap(jax.value_and_grad(jlogpost))(th),
                                             jmcmc.log_joint(jP, lat, jdata)))(
        jnp.asarray(thetas), jlatents)
    tv, tg = tmcmc.value_and_grad(logpost, torch.tensor(thetas))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())

    # log_joint alone, at the starting latents with a chain dim of 1
    tl = {k: DT(v.data[None], ("chain",) + v.dims) for k, v in latents.items()}
    np.testing.assert_allclose(tmcmc.log_joint(P, tl, data).numpy(),
                               [float(jlj)], rtol=1e-5)


@pytest.mark.parametrize("kind,event", [("id", (3,)), ("exp", (3,)), ("sigmoid", (3,)),
                                        ("stickbreak", (4,)), ("corrchol", (6,))])
def test_transforms_match_jax(kind, event):
    u = np.random.default_rng(2).standard_normal((3, 2) + event).astype(np.float32)
    x, ld = tmcmc._constrain(kind, torch.tensor(u))
    jx, jld = jax.jit(jax.vmap(lambda a: jmcmc._constrain(kind, a)))(jnp.asarray(u))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-5, atol=1e-5)
    back = tmcmc._unconstrain(kind, x)
    np.testing.assert_allclose(back.numpy(), u, rtol=1e-3, atol=1e-3)
    if kind in ("stickbreak", "corrchol"):
        inv = {"stickbreak": jmcmc._stickbreak_inv, "corrchol": jmcmc._corrchol_inv}[kind]
        np.testing.assert_allclose(back.numpy(), np.asarray(jax.jit(inv)(jx)), rtol=1e-5,
                                   atol=1e-5)


def test_latent_specs_refuse_discrete_and_unknown_supports():
    P = BoundPlate(Plate(p=Dirichlet(torch.ones(3)), c=Categorical(probs="p")), {},
                   device="cpu")
    with pytest.raises(ValueError, match="discrete"):
        tmcmc.make_logpost(P, {})
    from alan_tpu_torch import Wishart
    P = BoundPlate(Plate(W=Wishart(3.0, covariance_matrix=torch.eye(2))), {}, device="cpu")
    with pytest.raises(ValueError, match="no unconstraining transform"):
        tmcmc.make_logpost(P, {})


# ---- whole runs given alan_tpu's noise -----------------------------------------

C, W, S = 2, 3, 3


def _per_iteration(k_run, salt, f):
    """Stack ``f(chain key)`` over chains and iterations as ``alan_tpu``
    folds them: warmup ``fold_in(k_run, i)``, sampling
    ``fold_in(fold_in(k_run, salt), i)``, each split into a key a chain."""
    keys = ([jax.random.fold_in(k_run, i) for i in range(W)]
            + [jax.random.fold_in(jax.random.fold_in(k_run, salt), i) for i in range(S)])
    out = [jax.vmap(f)(jax.random.split(k, C)) for k in keys]
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]), *out)


def test_run_hmc_matches_jax():
    jP, jdata, P, data = linear_gaussian()
    key = jax.random.key(0)
    jsamples, jd = jmcmc.run_hmc(jP, jdata, num_samples=S, num_warmup=W, num_chains=C,
                                 num_leapfrog=4, key=key)
    k_init, k_run = jax.random.split(key)
    D = 1

    def chain(k):
        k1, k2 = jax.random.split(k)
        return jax.random.normal(k1, (D,)), jax.random.uniform(k2)
    momenta, uniforms = _per_iteration(k_run, 777, chain)
    noise = {"init": np.asarray(jax.random.normal(k_init, (C, D))),
             "momenta": momenta, "uniforms": uniforms}
    samples, d = tmcmc.run_hmc(P, data, num_samples=S, num_warmup=W, num_chains=C,
                               num_leapfrog=4, latents=_start(jP, jdata), noise=noise)
    np.testing.assert_allclose(samples["a"].data.numpy(), np.asarray(jsamples["a"].data),
                               rtol=1e-4, atol=1e-4)
    assert samples["a"].dims == ("draw", "chain")
    assert d["step_size"] == pytest.approx(jd["step_size"], rel=1e-4)
    assert d["mean_accept"] == pytest.approx(jd["mean_accept"], rel=1e-4, abs=1e-5)


def test_run_nuts_matches_jax():
    jP, jdata, P, data = linear_gaussian()
    MD, D, key = 3, 1, jax.random.key(3)
    jsamples, jd = j_run_nuts(jP, jdata, num_samples=S, num_warmup=W, num_chains=C,
                              max_depth=MD, key=key)
    k_init, k_run = jax.random.split(key)

    def chain(k):
        k_mom, k_loop = jax.random.split(k)
        dirs, merge, leaf = [], [], []
        for dd in range(MD):
            kd, ks, k_loop = jax.random.split(jax.random.fold_in(k_loop, dd), 3)
            dirs.append(jax.random.bernoulli(kd))
            kk = jax.random.fold_in(ks, 1)
            for _ in range(2 ** dd):
                kk, k1 = jax.random.split(kk)
                leaf.append(jax.random.uniform(k1))
            merge.append(jax.random.uniform(jax.random.fold_in(ks, 2)))
        return (jax.random.normal(k_mom, (D,)), jnp.stack(dirs), jnp.stack(merge),
                jnp.stack(leaf))
    momenta, dirs, merge, leaf = _per_iteration(k_run, 999, chain)
    noise = {"init": np.asarray(jax.random.normal(k_init, (C, D))), "momenta": momenta,
             "directions": dirs, "merge": merge, "leaf": leaf}
    samples, d = run_nuts(P, data, num_samples=S, num_warmup=W, num_chains=C,
                          max_depth=MD, latents=_start(jP, jdata), noise=noise)
    np.testing.assert_allclose(samples["a"].data.numpy(), np.asarray(jsamples["a"].data),
                               rtol=1e-4, atol=1e-4)
    assert d["step_size"] == pytest.approx(jd["step_size"], rel=1e-4)
    assert d["mean_accept"] == pytest.approx(jd["mean_accept"], rel=1e-4, abs=1e-5)


def test_run_smc_matches_jax():
    jP, jdata, P, data = linear_gaussian()
    N, M, key, stages = 64, 8, jax.random.key(1), 6
    jsamples, jinfo = j_run_smc(jP, jdata, num_particles=N, mutation_steps=M,
                                step_size=0.3, key=key)
    assert jinfo["stages"] <= stages
    keys = jax.random.split(key, 4)
    particles = np.stack([np.asarray(jP.sample(key=k)["a"].data).reshape(-1)
                          for k in jax.random.split(keys[0], N)])
    k_loop, resample, normals, uniforms = keys[1], [], [], []
    for _ in range(stages):
        k_loop, k_rs, k_mut = jax.random.split(k_loop, 3)
        resample.append(jax.random.uniform(k_rs))
        ks = [jax.random.split(k) for k in jax.random.split(k_mut, M)]
        normals.append(jnp.stack([jax.random.normal(k1, (N, 1)) for k1, _ in ks]))
        uniforms.append(jnp.stack([jax.random.uniform(k2, (N,)) for _, k2 in ks]))
    noise = {"resample": np.stack(resample), "normals": np.stack(normals),
             "uniforms": np.stack(uniforms)}
    samples, info = run_smc(P, data, num_particles=N, mutation_steps=M, step_size=0.3,
                            latents=_start(jP, jdata), particles=particles, noise=noise)
    assert info["stages"] == jinfo["stages"]
    assert info["final_lambda"] == jinfo["final_lambda"] == 1.0
    assert info["log_Z"] == pytest.approx(jinfo["log_Z"], abs=1e-4)
    np.testing.assert_allclose(samples["a"].data.numpy(), np.asarray(jsamples["a"].data),
                               rtol=1e-4, atol=1e-4)
    assert info["host_syncs"] <= 32 * info["stages"]


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_samplers_run_in_the_data_dtype(sampler, dtype):
    """The chains run in the data's float dtype: float64 data, float64
    draws (full-size covid's float32 log posterior rounds by tens of nats,
    more than a leapfrog's energy error)."""
    _, _, P, data = linear_gaussian()
    data = {k: DT(v.data.to(dtype), v.dims) for k, v in data.items()}
    run = {"hmc": tmcmc.run_hmc, "nuts": run_nuts}[sampler]
    kw = {"num_leapfrog": 2} if sampler == "hmc" else {"max_depth": 2}
    samples, d = run(P, data, num_samples=2, num_warmup=2, num_chains=2,
                     generator=torch.Generator().manual_seed(0), **kw)
    assert d["theta"].dtype == samples["a"].data.dtype == dtype
    assert torch.isfinite(d["theta"]).all() and np.isfinite(d["step_size"])


# ---- diagnostics ----------------------------------------------------------------

def test_diagnostics_match_jax():
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.standard_normal((120, 4, 3)), axis=0).astype(np.float32) * 0.1
    x += rng.standard_normal((120, 4, 3)).astype(np.float32)
    jx = JDT(jnp.asarray(x), ("draw", "chain"))
    tx = DT(torch.tensor(x), ("draw", "chain"))
    np.testing.assert_allclose(tdiag.split_rhat(tx), jdiag.split_rhat(jx), rtol=1e-6)
    np.testing.assert_allclose(tdiag.ess_bulk(tx), jdiag.ess_bulk(jx), rtol=1e-6)
    # draws with the dims in another order are laid out (draw, chain) first
    tswap = DT(torch.tensor(x).transpose(0, 1).contiguous(), ("chain", "draw"))
    np.testing.assert_allclose(tdiag.ess_bulk(tswap), jdiag.ess_bulk(jx), rtol=1e-6)
    ts, js = tdiag.summary({"x": tx}), jdiag.summary({"x": jx})
    for k in ("mean", "sd", "rhat_max", "ess_min"):
        np.testing.assert_allclose(ts["x"][k], js["x"][k], rtol=1e-6)
