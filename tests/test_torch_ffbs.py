"""FFBS, the timeseries read-out and Timeseries draws in Q: the port against
``alan_tpu``.

Both packages get the same numpy inputs and the same particles (drawn by
``alan_tpu``, carried across with ``convert.tree_from_numpy``); the port
runs on the CPU.  ``alan_tpu``'s side runs under ``jax.jit`` with every
``jax.random.categorical`` and ``jax.random.normal`` recorded and
``jax.lax.scan`` unrolled (``test_torch_harness.jax_recorded``), and the
port takes the recorded Gumbel noise through ``noise=`` and the recorded
standard-normal noise through ``extend(noise=...)``.

* ``dims.concat_dim``, ``reduce_ks._index_dim_int`` and
  ``_categorical_over``: equal to ``alan_tpu``'s; the filter's log-matvec
  against float64 where ``alan_tpu``'s shifted matmul underflows.
* FFBS draws equal to ``alan_tpu``'s under the same noise, or near-ties
  (the two picks' perturbed scores within 1e-4 relative), with the same
  route log, on AR(1), two coupled chains (the joint route), three
  independent chains with ``ALAN_TPU_FFBS_JOINT_MAX=100`` (three singleton
  routes), the conditional route on the coupled pair and on three coupled
  chains, a chain whose transition reads a per-step latent (the lagged
  ``_index_all``), and covid at 3 regions x 8 training days.
* AR(1)'s importance mean at K=1000 within 6 standard errors (at the
  marginals' ESS) of the Kalman smoother's mean.
* The ELBO of a model with a Timeseries in Q from ``alan_tpu``'s particles
  within 1e-5 relative; the K > 1 draws' per-step permutation equal to
  ``alan_tpu``'s; ``ALAN_TPU_TS_JOINT=1`` against the component path.
* Covid's ``extend`` and ``predictive_ll`` from the same importance samples
  and noise within 1e-5 relative, and the read-out entry points on covid
  and AR(1).
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch

import alan_tpu
import alan_tpu_torch
from alan_tpu import dims as jdims
from alan_tpu import reduce_ks as jreduce
from alan_tpu.importance import ImportanceSample as JImportanceSample
from alan_tpu.ir.timeseries import Timeseries as JTimeseries
from alan_tpu.sample import Sample as JSample, index_into_sample as j_index_into_sample
from alan_tpu.sampler import PermutationSampler as JPerm
from alan_tpu.split import no_checkpoint as j_no_checkpoint
from alan_tpu_torch import convert, moments, predict
from alan_tpu_torch import dims as tdims
from alan_tpu_torch import reduce_ks as treduce
from alan_tpu_torch.importance import ImportanceSample
from alan_tpu_torch.ir.timeseries import Timeseries
from alan_tpu_torch.models import ar1 as tar1
from alan_tpu_torch.models import covid as tcovid
from alan_tpu_torch.sample import Sample
from alan_tpu_torch.sampler import PermutationSampler
from alan_tpu_torch.split import no_checkpoint
from alan_tpu_torch.utils import KeyGen
from test_torch_harness import (Env, assert_dt_close, assert_same_draws, jax_dt,
                                jax_recorded, port_draws, port_np, to_numpy_tree)

import model_double_timeseries as jdouble
import model_indep_timeseries as jindep
import model_timeseries as jar1

REL = 1e-5


def port_dt(a, *dims):
    return convert.dt_from_numpy(np.asarray(a), dims, "cpu")


# ---- the models, built alike in both packages ---------------------------------

def ar1_model(ns):
    P = ns.Plate(init=ns.Normal(0, jar1.init_scale), T=ns.Plate(
        ts=ns.Timeseries("init", ns.Normal(lambda prev: jar1.A * prev,
                                           jar1.ts_noise_scale)),
        obs=ns.Normal("ts", jar1.obs_noise_scale)))
    Q = ns.Plate(init=ns.Normal(0, 1), T=ns.Plate(ts=ns.Normal(0, 1), obs=ns.Data()))
    return P, Q, {"T": jar1.T}, {"obs": (jar1.data_ts, ("T",))}


def double_model(ns):
    """``tests/model_double_timeseries.py``: two chains, one observation of
    their sum."""
    m = jdouble
    P = ns.Plate(init1=ns.Normal(0, m.init_scale), init2=ns.Normal(0, m.init_scale),
                 T=ns.Plate(
                     ts1=ns.Timeseries("init1", ns.Normal(lambda prev: m.A1 * prev,
                                                          m.ts_noise_scale)),
                     ts2=ns.Timeseries("init2", ns.Normal(lambda prev: m.A2 * prev,
                                                          m.ts_noise_scale)),
                     obs=ns.Normal(lambda ts1, ts2: ts1 + ts2, m.obs_noise_scale)))
    Q = ns.Plate(init1=ns.Normal(0, 1), init2=ns.Normal(0, 1),
                 T=ns.Plate(ts1=ns.Normal(0, 1), ts2=ns.Normal(0, 1), obs=ns.Data()))
    return P, Q, {"T": m.T}, {"obs": (m.data_ts, ("T",))}


def indep_model(ns):
    """``tests/model_indep_timeseries.py``: three chains, each observed."""
    m = jindep
    inits = {f"init{i}": ns.Normal(0, m.init_scale) for i in (1, 2, 3)}
    a1, a2, a3 = m.AS
    chains = {f"ts{i}": ns.Timeseries(f"init{i}", ns.Normal(f, m.ts_noise_scale))
              for i, f in ((1, lambda prev: a1 * prev), (2, lambda prev: a2 * prev),
                           (3, lambda prev: a3 * prev))}
    obs = {f"obs{i}": ns.Normal(f"ts{i}", m.obs_noise_scale) for i in (1, 2, 3)}
    P = ns.Plate(**inits, T=ns.Plate(**chains, **obs))
    Q = ns.Plate(**{k: ns.Normal(0, 1) for k in inits},
                 T=ns.Plate(**{k: ns.Normal(0, 1) for k in chains},
                            **{k: ns.Data() for k in obs}))
    data = {k: (np.asarray(v.data), ("T",)) for k, v in m.data.items()}
    return P, Q, {"T": m.T}, data


def three_coupled_model(ns):
    """``tests/test_ts_decomp.py:149-200``: three chains, one observation of
    their sum."""
    T = 5
    P = ns.Plate(
        init1=ns.Normal(0., 1.), init2=ns.Normal(0., 1.), init3=ns.Normal(0., 1.),
        T=ns.Plate(
            ts1=ns.Timeseries("init1", ns.Normal(lambda prev: 0.9 * prev, 0.4)),
            ts2=ns.Timeseries("init2", ns.Normal(lambda prev: 0.5 * prev, 0.4)),
            ts3=ns.Timeseries("init3", ns.Normal(lambda prev: -0.7 * prev, 0.4)),
            obs=ns.Normal(lambda ts1, ts2, ts3: ts1 + ts2 + ts3, 1.0)))
    Q = ns.Plate(
        init1=ns.Normal(0., 1.), init2=ns.Normal(0., 1.), init3=ns.Normal(0., 1.),
        T=ns.Plate(ts1=ns.Normal(0., 1.), ts2=ns.Normal(0., 1.),
                   ts3=ns.Normal(0., 1.), obs=ns.Data()))
    y = np.random.default_rng(11).standard_normal(T).astype(np.float32) * 1.5
    return P, Q, {"T": T}, {"obs": (y, ("T",))}


def nonts_model(ns):
    """``tests/test_ts_decomp.py:102-122``: a per-step latent ``w`` drives
    the transition, so its K-dim couples into the chain factor."""
    T = 6
    P = ns.Plate(init=ns.Normal(0., 1.), T=ns.Plate(
        w=ns.Normal(0., 1.),
        ts=ns.Timeseries("init", ns.Normal(lambda prev, w: 0.8 * prev + w, 0.3)),
        obs=ns.Normal("ts", 0.5)))
    Q = ns.Plate(init=ns.Normal(0., 1.), T=ns.Plate(
        w=ns.Normal(0., 1.), ts=ns.Normal(0., 1.5), obs=ns.Data()))
    y = np.cumsum(np.random.default_rng(5).standard_normal(T)).astype(np.float32)
    return P, Q, {"T": T}, {"obs": (y, ("T",))}


def ts_in_q_model(ns):
    """``tests/test_examples.py:66-90``: Q itself holds a Timeseries."""
    P = ns.Plate(init=ns.Normal(0., 1.), T=ns.Plate(
        ts=ns.Timeseries("init", ns.Normal(lambda prev: 0.9 * prev, 0.1)),
        obs=ns.Normal("ts", 1.)))
    Q = ns.Plate(init=ns.Normal(0., 1.), T=ns.Plate(
        ts=ns.Timeseries("init", ns.Normal(lambda prev: 0.9 * prev, 0.2)),
        obs=ns.Data()))
    y = np.random.default_rng(0).standard_normal(5).astype(np.float32)
    return P, Q, {"T": 5}, {"obs": (y, ("T",))}


def problems(model):
    """(alan_tpu's problem, the port's problem) of ``model``."""
    jP, jQ, sizes, data = model(alan_tpu)
    jprob = alan_tpu.Problem(alan_tpu.BoundPlate(jP, sizes), alan_tpu.BoundPlate(jQ, sizes),
                             {k: jax_dt(np.asarray(a, np.float32), *d)
                              for k, (a, d) in data.items()})
    tP, tQ, _, _ = model(alan_tpu_torch)
    B = alan_tpu_torch.BoundPlate
    tprob = alan_tpu_torch.Problem(
        B(tP, sizes, device="cpu"), B(tQ, sizes, device="cpu"),
        {k: port_dt(np.asarray(a, np.float32), *d) for k, (a, d) in data.items()},
        device="cpu")
    return jprob, tprob


def jax_particles(jprob, K, seed, state=None):
    """alan_tpu's particles (jitted) and the port's copy."""
    jtree = jax.jit(lambda key: jprob.Q._sample(K, False, JPerm, jprob.all_platedims,
                                                key, state=state)[0])(jax.random.key(seed))
    return jtree, convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")


def jax_elbo(jprob, jtree, gv2K):
    """alan_tpu's ELBO of the particles, jitted (eager JAX compiles every op
    of the traversal on its own)."""
    return jax.jit(lambda tree: JSample(jprob, tree, gv2K, JPerm, False).elbo_nograd())(jtree)


def assert_same_indices(jidx, tidx, ties=0):
    """Equal indices, but where a near-tie drew another particle (each tie
    changes one joint index, of at most ``len(jidx)`` groups)."""
    assert set(jidx) == set(tidx)
    differ = 0
    for k, j in jidx.items():
        t = tidx[k]
        assert set(j.dims) == set(t.dims)
        differ += int(np.sum(port_np(t, j.dims) != np.asarray(j.data)))
    assert differ <= ties * len(jidx), (differ, ties)


# ---- concat_dim and the helpers -------------------------------------------------

def test_concat_dim_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 2, 4, 5)).astype(np.float32)     # (K, T, R, pos)
    b = rng.standard_normal((4, 3, 6, 5)).astype(np.float32)     # (R, K, T, pos)
    want = jdims.concat_dim([jax_dt(a, "K", "T", "R"), jax_dt(b, "R", "K", "T")], "T")
    got = tdims.concat_dim([port_dt(a, "K", "T", "R"), port_dt(b, "R", "K", "T")], "T")
    assert got.dims == tuple(want.dims) and got.dim_size("T") == 8
    assert got.pos_shape == (5,)
    np.testing.assert_array_equal(port_np(got), np.asarray(want.data))
    with pytest.raises(ValueError, match="mismatched"):
        tdims.concat_dim([port_dt(a, "K", "T", "R"), port_dt(b[0], "K", "T")], "T")


def test_index_dim_int_and_categorical_over_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 4)).astype(np.float32)
    for i in (0, 6):
        assert_dt_close(jreduce._index_dim_int(jax_dt(x, "R", "T", "K"), "T", i),
                        treduce._index_dim_int(port_dt(x, "R", "T", "K"), "T", i), 0, 0)
    layouts = (("R", "T", "K"), ("R", "N", "K"))

    def draw(key):
        return [jreduce._categorical_over(jax_dt(x, *dims), "K", "N", 9,
                                          jax.random.fold_in(key, i))
                for i, dims in enumerate(layouts)]
    wants, jd = jax_recorded(draw, jax.random.key(2))
    for dims, want, (g, _, _) in zip(layouts, wants, jd):
        got = treduce._categorical_over(port_dt(x, *dims), "K", "N", 9,
                                        KeyGen(None), iter([g]))
        assert_dt_close(want, got, 0, 0)


def test_log_matvec_is_exact_where_shifted_matmul_underflows(monkeypatch):
    """The filter's log-matvec against a float64 logsumexp: terms ~1e4
    nats apart (covid's transitions at Q's initial state), where
    alan_tpu's separately shifted matmul gives -inf; a column of -inf
    gives -inf, not NaN; chunks over alpha's extra dims change nothing."""
    rng = np.random.default_rng(6)
    alpha = torch.from_numpy(rng.normal(0, 3e3, (5, 4, 6)).astype(np.float32))
    M = torch.from_numpy(rng.normal(0, 3e3, (4, 6, 7)).astype(np.float32))
    M[..., 2] = -np.inf
    want = torch.logsumexp(alpha.double().unsqueeze(-1) + M.double(), dim=-2)
    got = treduce._log_matvec(alpha, M)
    assert torch.isinf(got[..., 2]).all() and not torch.isnan(got).any()
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin].double(), want[fin], rtol=1e-6, atol=0)
    # alan_tpu's form (reduce_ks.py:484-494, nested in _ffbs_joint) loses
    # finite entries here
    a_max = alpha.amax(-1, keepdim=True)
    m_max = M.amax(-2, keepdim=True).clamp(min=-3e38)
    shifted = torch.log(torch.matmul(torch.exp(alpha - a_max).unsqueeze(-2),
                                     torch.exp(M - m_max)).squeeze(-2))
    assert torch.isinf(shifted[fin]).any()
    monkeypatch.setattr(treduce, "_MATVEC_CHUNK", 4 * 6 * 7)
    torch.testing.assert_close(treduce._log_matvec(alpha, M), got, rtol=0, atol=0)


# ---- FFBS draws ---------------------------------------------------------------

COVID_SMALL = dict(nRs=3, nDs=10)
Q_SCALE = 0.003


def covid_model_problems(K_seed=3):
    """Covid at 3 regions x 8 training days (10 in all) with a QEM Q in both
    packages, its all-days covariates and data, and counts of a few
    hundred (test_torch_timeseries.covid_setup says why)."""
    import covid as jcovid
    nRs, nDs = COVID_SMALL["nRs"], COVID_SMALL["nDs"]
    arrays = tcovid.fake_data(seed=4, **COVID_SMALL)
    arrays["obs"] = np.random.default_rng(4).poisson(300.0, (nRs, nDs)).astype(np.float32)
    nDs_train = int(0.8 * nDs)
    nm = ("nRs", "nDs")
    names = {"ActiveCMs_NPIs": "npis", "ActiveCMs_wearing": "wearing",
             "ActiveCMs_mobility": "mobility"}
    out = {}
    for pkg, mk in (("jax", jax_dt), ("port", port_dt)):
        cut = {k: mk(arrays[v][:, :nDs_train], *nm) for k, v in names.items()}
        full = {k: mk(arrays[v], *nm) for k, v in names.items()}
        out[pkg] = (cut, full, {"obs": mk(arrays["obs"][:, :nDs_train], *nm)},
                    {"obs": mk(arrays["obs"], *nm)})
    ps = {"nRs": nRs, "nDs": nDs_train}
    jprob = jcovid.generate_problem(ps, out["jax"][2], out["jax"][0], "qem")
    tprob = tcovid.generate_problem(ps, out["port"][2], out["port"][0], "qem",
                                    device="cpu")
    # Q centred on the latents the covariates were drawn with: at Q's
    # initial state the particles of consecutive days lie ~1e4 nats apart
    # under the transition (scale ~0.01), and alan_tpu's filter
    # (reduce_ks.py:484-494) underflows to -inf there
    st = jprob.Q.state()
    qp = dict(st["qem_params"])
    for k, v in qp.items():
        name, arg = k.rsplit("_", 1)
        truth = arrays[name][..., :nDs_train] if name == "log_infected" else arrays[name]
        val = truth if arg == "loc" else np.full(np.shape(truth), Q_SCALE, np.float32)
        qp[k] = jax_dt(np.asarray(val, np.float32), *v.dims)
    jstates = (jprob.P.state(), {**st, "qem_params": qp})
    tstates = tuple(convert.state_from_numpy(to_numpy_tree(x), "cpu") for x in jstates)
    return jprob, tprob, {"nRs": nRs, "nDs": nDs}, out, jstates, tstates


FFBS_CASES = {
    # name: (model, K, N, env, routes)
    "ar1": (ar1_model, 30, 40, {}, [("joint", ("K_ts",))]),
    "coupled": (double_model, 8, 40, {}, [("joint", ("K_ts1", "K_ts2"))]),
    "independent": (indep_model, 12, 40, {"ALAN_TPU_FFBS_JOINT_MAX": 100},
                    [("joint", ("K_ts1",)), ("joint", ("K_ts2",)),
                     ("joint", ("K_ts3",))]),
    "coupled_conditional": (double_model, 8, 40, {"ALAN_TPU_FFBS_JOINT_MAX": 1},
                            [("conditional", ("K_ts1", "K_ts2"))]),
    "three_conditional": (three_coupled_model, 10, 30, {"ALAN_TPU_FFBS_JOINT_MAX": 500},
                          [("conditional", ("K_ts1", "K_ts2", "K_ts3"))]),
    "nonts_factor": (nonts_model, 10, 40, {}, [("joint", ("K_ts",))]),
}


@functools.lru_cache(maxsize=None)
def problems_and_particles(model, K):
    """``problems(model)`` and ``jax_particles`` of it at K, built once a
    module (two cases share the coupled pair)."""
    jprob, tprob = problems(model)
    return (jprob, tprob) + jax_particles(jprob, K, seed=K)


@pytest.mark.parametrize("case", list(FFBS_CASES))
def test_ffbs_draws_match_jax(case):
    model, K, N, env, routes = FFBS_CASES[case]
    jprob, tprob, jtree, ttree = problems_and_particles(model, K)
    gv2K = jprob.Q.plate.groupvarname2Kdim(K)
    js = JSample(jprob, jtree, gv2K, JPerm, False)
    with Env(**env):
        jidx, jd = jax_recorded(
            lambda key: js._importance_sample_idxs(N, j_no_checkpoint, key)[0],
            jax.random.key(11))
        assert list(jreduce._ffbs_routes) == routes
        ts = Sample(tprob, ttree, gv2K, PermutationSampler, False)
        with port_draws() as td:
            tidx, _ = ts._importance_sample_idxs(N, no_checkpoint,
                                                 noise=[g for g, _, _ in jd])
    assert list(treduce._ffbs_routes) == routes
    ties = assert_same_draws(jd, td)
    assert ties <= 2
    assert_same_indices(jidx, tidx, ties)


class CovidCase:
    """Covid at 3 regions x 8 + 2 days, K=5, N=20, in both packages from one
    particle tree: alan_tpu's importance samples, their extension over the
    10 days and the predictive log-likelihood in one jitted program, its
    Gumbel and standard-normal noise recorded; the port's importance
    indices from the same Gumbel noise."""
    K, N = 5, 20

    def __init__(self):
        (self.jprob, self.tprob, self.all_ps, self.arrays, states,
         self.tstates) = covid_model_problems()
        jtree, ttree = jax_particles(self.jprob, self.K, seed=3, state=states[1])
        gv2K = self.jprob.Q.plate.groupvarname2Kdim(self.K)
        v2g = self.jprob.Q.plate.varname2groupvarname()
        js = JSample(self.jprob, jtree, gv2K, JPerm, False, states=states)
        cov_all, obs_all = self.arrays["jax"][1], self.arrays["jax"][3]

        def pipeline(k1, k2):
            idx, _ = js._importance_sample_idxs(self.N, j_no_checkpoint, k1)
            samples = j_index_into_sample(js.detached_sample, idx, gv2K, v2g)
            # a copy of the tree: alan_tpu's extension writes into the one it gets
            isamp = JImportanceSample(self.jprob, jax.tree.map(lambda x: x, samples),
                                      "N", states=states)
            ext = isamp.extend(self.all_ps, cov_all, key=k2)
            return idx, samples, ext.dump(), ext.predictive_ll(obs_all)

        ((self.jidx, self.jsamples, self.jext, self.jpll), self.jd,
         self.normals) = jax_recorded(pipeline, jax.random.key(12), jax.random.key(14),
                                      normals=True)
        self.jroutes = list(jreduce._ffbs_routes)
        ts = Sample(self.tprob, ttree, gv2K, PermutationSampler, False,
                    states=self.tstates)
        with port_draws() as self.td:
            self.tidx, _ = ts._importance_sample_idxs(self.N, no_checkpoint,
                                                      noise=[g for g, _, _ in self.jd])
        self.troutes = list(treduce._ffbs_routes)


@pytest.fixture(scope="module")
def covid_case():
    return CovidCase()


def test_ffbs_covid_draws_match_jax(covid_case):
    """Covid's day plate: one joint route over K_log_infected, whose init
    K-dim K_a enters through alpha_0 and is then indexed by the lagged
    trajectory."""
    c = covid_case
    assert c.jroutes == c.troutes == [("joint", ("K_log_infected",))]
    # the root group, the regions' group, then the chain's 8 days
    assert len(c.td) == 2 + 8
    ties = assert_same_draws(c.jd, c.td)
    assert ties <= 2
    assert_same_indices(c.jidx, c.tidx, ties)
    assert set(c.tidx["log_infected"].dims) == {"nDs", "N", "nRs"}


def test_ar1_importance_mean_matches_kalman():
    """At K=1000 each step's mean of N=100 draws lies within 6 standard
    errors of the Kalman smoother's mean: sqrt(var / ESS + var / N), the
    draws' variance, the marginals' least ESS (the particles' error) and N
    (the draws')."""
    prob = tar1.generate_problem("cpu")
    gen = torch.Generator().manual_seed(0)
    s = prob.sample(1000, gen, reparam=False)
    N = 100
    ts = s.importance_sample(N, gen).dump()["ts"].with_dims_front(["T"]).data
    ess = float(s.marginals().min_ess())
    se = torch.sqrt(ts.var(1) * (1 / ess + 1 / N)).numpy()
    dev = np.abs(ts.mean(1).numpy() - tar1.post_mean)
    assert ess > 100 and np.all(dev < 6 * se), (dev, se, ess)


def test_ar1_read_out_entry_points_run():
    """``predict.importance_sample_fn`` and ``predictive_ll_fn`` on AR(1):
    extended by 2 steps, the chain rolls forward and the held-out
    observations score finite; not extended, the predictive
    log-likelihood of the training data given itself is 0."""
    prob = tar1.generate_problem("cpu")
    gen = torch.Generator().manual_seed(3)
    state = (prob.P.state(), prob.Q.state())
    draws = predict.importance_sample_fn(prob, 30, 40)(*state, gen)
    assert set(draws["ts"].dims) == {"T", "N"}
    y = np.concatenate([tar1.data_ts, [0.3, -0.2]]).astype(np.float32)
    all_obs = {"obs": port_dt(y, "T")}
    pll = predict.predictive_ll_fn(prob, 30, 40, {"T": tar1.T + 2})(*state, {}, all_obs,
                                                                    gen)
    assert math.isfinite(float(pll["obs"]))
    same = predict.predictive_ll_fn(prob, 30, 40, {"T": tar1.T})(
        *state, {}, {"obs": port_dt(tar1.data_ts.astype(np.float32), "T")}, gen)
    assert float(same["obs"]) == 0.0


# ---- a Timeseries in Q --------------------------------------------------------

def test_timeseries_in_q_elbo_matches_jax():
    jprob, tprob = problems(ts_in_q_model)
    K = 4
    jtree, ttree = jax_particles(jprob, K, seed=0)
    gv2K = jprob.Q.plate.groupvarname2Kdim(K)
    want = float(jax_elbo(jprob, jtree, gv2K))
    got = float(Sample(tprob, ttree, gv2K, PermutationSampler, False).elbo_nograd())
    assert abs(got - want) <= REL * abs(want), (got, want)
    # the port's own K > 1 draw of the same Q, reparameterised
    s = tprob.sample(K, torch.Generator().manual_seed(1), reparam=True)
    assert math.isfinite(float(s.elbo_vi()))


def test_timeseries_k_draws_permuted_ancestry_matches_jax():
    """With a transition of scale 0, step t + 1 of particle k is a function
    of step t's particle ``perm[t, k]``: the port's chain equals
    ``alan_tpu``'s under the same per-step permutation."""
    R, T, K = 2, 5, 6
    rng = np.random.default_rng(3)
    init = rng.standard_normal((K, R)).astype(np.float32)
    perm = np.stack([[rng.permutation(K) for _ in range(T)] for _ in range(R)])
    sizes = {"R": R, "T": T, "K_ts": K}
    out = {}
    for pkg, Ts, Nm, mk, key in (
            ("jax", JTimeseries, alan_tpu.Normal, jax_dt, jax.random.key(0)),
            ("port", Timeseries, alan_tpu_torch.Normal, port_dt, torch.Generator())):
        ts = Ts("init", Nm(lambda prev: 0.5 * prev + 1.0, 0.0))
        out[pkg] = ts.sample({"init": mk(init, "K_ts", "R")}, key, False, ["R", "T"],
                             "K_ts", sizes, timeseries_perm=mk(perm, "R", "T"))
    assert_dt_close(out["jax"], out["port"], 1e-6, 1e-6)
    x = port_np(out["port"], ("R", "T", "K_ts"))
    for r in range(R):
        for t in range(T - 1):
            np.testing.assert_allclose(x[r, t + 1], 0.5 * x[r, t][perm[r, t]] + 1.0,
                                       rtol=1e-6)


def test_timeseries_in_q_draws_a_permutation_per_step(monkeypatch):
    """``sample_gdt`` hands a group with a Timeseries the sampler's
    permutation over its K-dim and plates, T among them; a group without
    one, or with one particle, draws none."""
    _, tprob = problems(ts_in_q_model)
    perms = []
    original = PermutationSampler.perm

    def recorded(dims, Kdim, dim_sizes, generator):
        p = original(dims, Kdim, dim_sizes, generator)
        perms.append(p)
        return p

    monkeypatch.setattr(PermutationSampler, "perm", staticmethod(recorded))
    tprob.sample(3, torch.Generator().manual_seed(0), reparam=False)
    assert [p.dims for p in perms] == [(), ("T",)]
    perms.clear()
    tprob.Q.sample(torch.Generator().manual_seed(0))
    assert [p.dims for p in perms] == [()]


@pytest.mark.parametrize("model,K", [(indep_model, 6), (double_model, 10)])
def test_ts_joint_switch_matches_components(model, K):
    """``ALAN_TPU_TS_JOINT=1`` contracts one joint chain; the component path
    gives the same ELBO, and both give alan_tpu's."""
    jprob, tprob = problems(model)
    jtree, ttree = jax_particles(jprob, K, seed=K)
    gv2K = jprob.Q.plate.groupvarname2Kdim(K)
    s = Sample(tprob, ttree, gv2K, PermutationSampler, False)
    e_comp = float(s.elbo_nograd())
    with Env(ALAN_TPU_TS_JOINT=1):
        e_joint = float(s.elbo_nograd())
    want = float(jax_elbo(jprob, jtree, gv2K))
    assert np.isclose(e_comp, e_joint, rtol=1e-5, atol=1e-4), (e_comp, e_joint)
    assert abs(e_comp - want) <= REL * abs(want), (e_comp, want)


# ---- covid: extension and predictive log-likelihood ------------------------------

def test_covid_extend_and_predictive_ll_match_jax(covid_case):
    """From alan_tpu's importance samples and its standard-normal noise, the
    port's roll-forward of log_infected over the 2 held-out days and the
    predictive log-likelihood of the 10 days within 1e-5 relative."""
    c = covid_case
    # nine global and regional latents, then one draw a held-out day
    assert len(c.normals) == 9 + 2
    normals = [torch.from_numpy(x) for x in c.normals]
    isamp = ImportanceSample(c.tprob, convert.tree_from_numpy(to_numpy_tree(c.jsamples),
                                                              "cpu"),
                             "N", states=c.tstates)
    ext = isamp.extend(c.all_ps, c.arrays["port"][1],
                       generator=torch.Generator().manual_seed(0), noise=normals)
    tpll = ext.predictive_ll(c.arrays["port"][3])
    for name in ("log_infected", "psi", "CM_alpha"):
        assert_dt_close(c.jext[name], ext.dump()[name], REL, REL)
    assert ext.dump()["log_infected"].dim_size("nDs") == c.all_ps["nDs"]
    assert set(tpll) == set(c.jpll) == {"obs"}
    want, got = float(c.jpll["obs"].data), float(tpll["obs"].data)
    assert abs(got - want) <= REL * abs(want), (got, want)
    with pytest.raises(ValueError, match="ran out"):
        isamp.extend(c.all_ps, c.arrays["port"][1], generator=torch.Generator(),
                     noise=normals[:-1])


def test_covid_read_out_entry_points_run(covid_case):
    """``marginals``, ``importance_sample``, ``predict.importance_sample_fn``
    and ``predict.predictive_ll_fn`` on covid with the port's own draws:
    finite, with the shapes of the extended plates; the importance mean of
    log_infected within 6 standard errors of the marginals' plus 12 times
    the particles' spread over N (Bernstein's term)."""
    tprob, all_ps, arrays, state = (covid_case.tprob, covid_case.all_ps,
                                    covid_case.arrays, covid_case.tstates)
    K, N = 5, 200
    gen = torch.Generator().manual_seed(5)
    tree, gv2K = tprob.Q._sample(K, False, PermutationSampler, tprob.all_platedims, gen,
                                 state=state[1])
    s = Sample(tprob, tree, gv2K, PermutationSampler, False, states=state)
    marg = s.marginals()
    isamp = s.importance_sample(N, gen)
    mm = marg.moments("log_infected", moments.mean)
    sd = marg.moments("log_infected", moments.var_from_raw_moment(moments.mean)).sqrt()
    x = marg.samples["log_infected"]
    spread = tdims.amax_dims((x - mm).abs(), ("K_log_infected",))
    im = isamp.moments("log_infected", moments.mean)
    band = 6 * sd / math.sqrt(N) + 12 * spread / N + 1e-5 * mm.abs()
    dev = (im - mm).abs()
    assert bool(((dev - band).data <= 0).all())

    draws = predict.importance_sample_fn(tprob, K, N)(*state, gen)
    assert draws["log_infected"].dim_size("N") == N
    pll = predict.predictive_ll_fn(tprob, K, N, all_ps)(
        *state, arrays["port"][1], arrays["port"][3], gen)
    assert set(pll) == {"obs"} and math.isfinite(float(pll["obs"]))
