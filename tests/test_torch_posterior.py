"""The port's posterior read-out against ``alan_tpu``: importance samples,
marginals, the moment algebra and the predictive log-likelihood.

Both packages get the same numpy inputs and the same particles (drawn by
``alan_tpu``, carried across with ``convert.tree_from_numpy``); the port
runs on the CPU.  The reverse replay draws by Gumbel-max in both: here
``jax.random.categorical`` is wrapped (``monkeypatch``, no file of
``alan_tpu`` changes) so that each call records its Gumbel noise,
``jax.random.gumbel(key, shape, dtype)``, after checking that
``argmax(noise + logits)`` is the call's own result; the port takes the
recorded noise, in the same order, through ``noise=``.

* (a) ``sample_Ks``'s draws and ``importance_sample().dump()`` on small
  MovieLens (M=12 users, 3 films, K=5, N=50), ungrouped, grouped and
  grouped through the port's lazy low-rank route: every draw equal, or a
  near-tie (the two candidates' perturbed scores within 1e-4 relative).
* (b) the marginal weights and their ESS within rtol 1e-4 / atol 1e-5
  (``allclose_dt`` of ``tests/test_problem_vs_itself.py``).
* (c) ``from_samples`` / ``from_marginals`` of mean, mean2, var, std,
  mean_log (of ``exp(psi_z)``) and cov_x against ``alan_tpu``'s.
* (d) ``predict.predictive_ll_fn`` on 3 + 3 films within 1e-5 relative of
  ``alan_tpu``'s pipeline; deterministic under one generator.
* (e) the counterparts of ``test_moments_sample_marginal`` and
  ``test_moments_importance_sample`` (``tests/test_problem_vs_itself.py:
  87-116``) on the linear-Gaussian zoo models, for both samplers.
* (f) ``CategoricalSampler`` draws uniformly, ``IndependentSampler`` is the
  identity, and the ELBO under ``CategoricalSampler`` is ``alan_tpu``'s.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from alan_tpu import dims as jdims
from alan_tpu.dims import DT as JDT
from alan_tpu import moments as jmoments
from alan_tpu.ir.plate import flatten_tree as j_flatten_tree
from alan_tpu.marginals import Marginals as JMarginals
from alan_tpu.sample import Sample as JSample, index_into_sample as j_index_into_sample
from alan_tpu.sampler import CategoricalSampler as JCat, PermutationSampler as JPerm
from alan_tpu.split import no_checkpoint as j_no_checkpoint
from alan_tpu_torch import (BoundPlate, CategoricalSampler, Data, IndependentSampler,
                            Normal, PermutationSampler, Plate, Problem, convert,
                            dims as tdims, moments as tmoments, no_checkpoint,
                            predict, samplers)
from alan_tpu_torch import reduce_ks as treduce
from alan_tpu_torch.models import ar1 as tar1
from alan_tpu_torch.models import movielens as tml
from alan_tpu_torch.ops import lowrank as tlr
from alan_tpu_torch.sample import Sample
from alan_tpu_torch.utils import KeyGen
from test_torch_harness import (Env, PORT_LAZY, assert_dt_close, assert_same_draws,
                                jax_dt, jax_movielens, jax_recorded, port_draws,
                                port_movielens, port_np, to_numpy_tree)

M, N_FILMS, K, N = 12, 3, 5, 50
#: alan_tpu's factored log-density evaluated densely (the cross product in
#: the order ``shared + x + params``), the port's materialised lazy factor
JAX_FACTORED = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK_MIN=1 << 40)
ROUTES = {"ungrouped": (False, {}, {}), "grouped": (True, {}, {}),
          "grouped_lazy": (True, JAX_FACTORED, PORT_LAZY)}
RTOL, ATOL = 1e-4, 1e-5


# ---- the MovieLens case --------------------------------------------------------

def near_truth_q_state(jprob, arrays, scale=0.2):
    """Q's state with each Normal centred on the latents the data came from
    (scale ``scale``, times z's prior scale for z): at Q's initial state the
    marginals put all their weight on one particle (ESS 1.0), and every
    draw would be the same."""
    st = jprob.Q.state()
    full = lambda v, *dims: JDT(jnp.asarray(v, jnp.float32), dims)
    z_scale = np.broadcast_to(np.exp(arrays["psi_z"]) * scale, arrays["z"].shape)
    qp = {**st["qem_params"],
          "mu_z_loc": full(arrays["mu_z"]), "mu_z_scale": full(np.full(18, scale)),
          "psi_z_loc": full(arrays["psi_z"]), "psi_z_scale": full(np.full(18, scale)),
          "z_loc": full(arrays["z"], "plate_1"), "z_scale": full(z_scale, "plate_1")}
    return {**st, "qem_params": qp}


class Case:
    """Small MovieLens in both packages at one state, one particle tree from
    alan_tpu, and the importance samples and marginals both draw from it
    with the same noise."""

    def __init__(self, route):
        grouped, jenv, tenv = ROUTES[route]
        self.jenv, self.tenv = jenv, tenv
        self.arrays = tml.fake_data(seed=3, M=M, N=N_FILMS, N_test=N_FILMS)
        self.jprob = jax_movielens(self.arrays, grouped)
        self.tprob = port_movielens(self.arrays, grouped)
        self.jstates = (self.jprob.P.state(), near_truth_q_state(self.jprob, self.arrays))
        self.tstates = tuple(convert.state_from_numpy(to_numpy_tree(s), "cpu")
                             for s in self.jstates)
        self.gv2K = self.jprob.Q.plate.groupvarname2Kdim(K)
        self.jtree = jax.jit(lambda key: self.jprob.Q._sample(
            K, False, JPerm, self.jprob.all_platedims, key,
            state=self.jstates[1])[0])(jax.random.key(7))
        self.ttree = convert.tree_from_numpy(to_numpy_tree(self.jtree), "cpu")
        v2g = self.jprob.Q.plate.varname2groupvarname()
        with Env(**jenv):
            self.js = JSample(self.jprob, self.jtree, self.gv2K, JPerm, False,
                              states=self.jstates)
            self.jidx, self.jd = jax_recorded(
                lambda key: self.js._importance_sample_idxs(N, j_no_checkpoint, key)[0],
                jax.random.key(11))
            weights = jax.jit(lambda: self.js.marginals(
                computation_strategy=j_no_checkpoint).weights)()
        self.jmarg = JMarginals(j_flatten_tree(self.js.detached_sample), weights,
                                self.jprob.all_platedims, v2g)
        self.noise = [g for g, _, _ in self.jd]
        self.jdump = j_flatten_tree(j_index_into_sample(
            self.js.detached_sample, self.jidx, self.gv2K, v2g))
        self.ts = Sample(self.tprob, self.ttree, self.gv2K, PermutationSampler, False,
                         states=self.tstates)
        with Env(**tenv), port_draws() as td:
            calls = tlr.CONTRACT_CALLS
            self.tidx, _ = self.ts._importance_sample_idxs(N, no_checkpoint,
                                                           noise=self.noise)
            self.tmarg = self.ts.marginals()
            self.lazy_calls = tlr.CONTRACT_CALLS - calls
            self.tisamp = self.ts.importance_sample(N, noise=self.noise)
        self.td = td


@pytest.fixture(scope="module", params=list(ROUTES))
def case(request):
    return Case(request.param)


def test_replay_draws_match_jax(case):
    ties = assert_same_draws(case.jd, case.td[:len(case.jd)])
    assert set(case.jidx) == set(case.tidx)
    if ties == 0:
        for k, j in case.jidx.items():
            t = case.tidx[k]
            assert set(j.dims) == set(t.dims)
            np.testing.assert_array_equal(port_np(t, j.dims), np.asarray(j.data))
    if case.tenv:
        # the lazy route's contraction and the source-term backward went
        # through the fused contraction: ELBO and marginals, and the replay
        assert case.lazy_calls >= 2


def test_importance_sample_dump_matches_jax(case):
    dump = case.tisamp.dump()
    assert set(dump) == set(case.jdump) == {"mu_z", "psi_z", "z"}
    for k, j in jax.tree.map(np.asarray, case.jdump).items():
        t = dump[k]
        assert "N" in t.dims and t.dim_size("N") == N
        assert set(t.dims) == set(j.dims)
        # the same particles picked: equal floats, near-ties aside
        same = port_np(t, j.dims) == j.data
        assert same.mean() >= 0.99, k


def test_marginals_and_ess_match_jax(case):
    assert set(case.jmarg.weights) == set(case.tmarg.weights)
    for k, j in case.jmarg.weights.items():
        assert_dt_close(j, case.tmarg.weights[k], RTOL, ATOL)
        np.testing.assert_allclose(float(jdims.sum_dims(j, tuple(
            d for d in j.dims if d.startswith("K_"))).data.mean()), 1.0, rtol=1e-5)
    jess, tess = case.jmarg.ess(), case.tmarg.ess()
    for k, j in jess.items():
        assert_dt_close(j, tess[k], RTOL, ATOL)
    np.testing.assert_allclose(float(case.tmarg.min_ess()),
                               float(case.jmarg.min_ess()), rtol=RTOL)


def test_joint_marginals_match_jax(case):
    """``marginals(joints=...)``: the joint weights of two latents of one
    plate, and the moment of a product of both, against alan_tpu's."""
    if case.jprob.Q.plate.varname2groupvarname()["mu_z"] != "mu_z":
        with pytest.raises(Exception, match="groupvarnames"):
            case.ts.marginals(joints=(("mu_z", "z"),))
        return
    joint = ("mu_z", "psi_z")
    with Env(**case.jenv):
        jw = jax.jit(lambda: case.js.marginals(
            joints=(joint,), computation_strategy=j_no_checkpoint).weights)()
    tm = case.ts.marginals(joints=(joint,))
    key = frozenset(joint)
    assert_dt_close(jw[key], tm.weights[key], RTOL, ATOL)
    jm = JMarginals(j_flatten_tree(case.js.detached_sample), jw,
                    case.jprob.all_platedims, case.jprob.Q.plate.varname2groupvarname())
    prod_j = jmoments.RawMoment(lambda a, b: a * b)
    prod_t = tmoments.RawMoment(lambda a, b: a * b)
    assert_dt_close(jm._moments(joint, prod_j), tm.moments(joint, prod_t), RTOL, ATOL)


MOMENTS = {
    "mean": (jmoments.mean, tmoments.mean, None),
    "mean2": (jmoments.mean2, tmoments.mean2, None),
    "var": (jmoments.var, tmoments.var, None),
    "std": (jmoments.std_from_raw_moment(jmoments.mean),
            tmoments.std_from_raw_moment(tmoments.mean), None),
    "mean_log": (jmoments.mean_log, tmoments.mean_log, "exp"),
    "cov_x": (jmoments.cov_x, tmoments.cov_x, None),
}


def moment_atol(m, x):
    """A compound moment (var, std, cov_x) subtracts raw moments of up to
    max x^2: its absolute error is measured on that scale."""
    if isinstance(m, tmoments.CompoundMoment):
        return ATOL * max(1.0, float(x.data.abs().max()) ** 2)
    return ATOL


@pytest.mark.parametrize("name", list(MOMENTS))
def test_moment_algebra_matches_jax(case, name):
    """Each moment from samples (Q's particles, their K-dim taken as the
    sample dim) and from marginal weights (Dirichlet draws over the same
    K-dims, per plate cell), in both packages.  Weights that resolve the
    variance: the model's own are nearly one-hot, where ``std`` is the
    square root of a rounding error."""
    jm, tm, transform = MOMENTS[name]
    rng = np.random.default_rng(0)
    v2g = case.jprob.Q.plate.varname2groupvarname()
    jflat, tflat = j_flatten_tree(case.js.detached_sample), case.ts.detached_sample
    tflat = {**tflat, **tflat["plate_1"]}
    ps = case.jprob.all_platedims
    for var in ("psi_z", "z"):
        jk, tk = jflat[var], tflat[var]
        if transform == "exp":
            jk, tk = jk.exp(), tk.exp()
        atol = moment_atol(tm, tk)
        kdim = case.gv2K[v2g[var]]
        assert_dt_close(jm.from_samples((jk,), kdim), tm.from_samples((tk,), kdim),
                        RTOL, atol)
        plates = [d for d in jk.dims if d != kdim]
        w = rng.dirichlet(np.ones(K), [ps[d] for d in plates]).astype(np.float32)
        jw = jax_dt(w, *plates, kdim)
        tw = convert.dt_from_numpy(w, (*plates, kdim), "cpu")
        assert_dt_close(jm.from_marginals((jk,), jw, ps), tm.from_marginals((tk,), tw, ps),
                        RTOL, atol)


def test_objects_moments_match_jax(case):
    """``Marginals.moments`` and ``ImportanceSample.moments`` of each latent
    against alan_tpu's."""
    tflat = {**case.ts.detached_sample, **case.ts.detached_sample["plate_1"]}
    for var in ("mu_z", "psi_z", "z"):
        for jm, tm in ((jmoments.mean, tmoments.mean), (jmoments.mean2, tmoments.mean2),
                       (jmoments.var, tmoments.var)):
            assert_dt_close(case.jmarg._moments(var, jm), case.tmarg.moments(var, tm),
                            RTOL, moment_atol(tm, tflat[var]))
            assert_dt_close(jm.from_samples((case.jdump[var],), "N"),
                            case.tisamp.moments(var, tm), RTOL,
                            moment_atol(tm, tflat[var]))


def test_predictive_ll_matches_jax(case):
    """``predictive_ll_fn`` on 3 training + 3 held-out films, given alan_tpu's
    particles and replay noise: alan_tpu's eager pipeline (importance
    sample, extend, predictive_ll) within 1e-5 relative."""
    a = case.arrays
    plates = ("plate_1", "plate_2")
    x_all = np.concatenate([a["x"], a["x_test"]], axis=1)
    obs_all = np.concatenate([a["obs"], a["obs_test"]], axis=1)
    all_ps = {"plate_1": M, "plate_2": 2 * N_FILMS}

    def pipeline(k_is, k_ext):
        jis = case.js.importance_sample(N, j_no_checkpoint, key=k_is)
        jext = jis.extend(all_ps, {"x": jax_dt(x_all, *plates)}, key=k_ext)
        return {k: v.data for k, v in
                jext.predictive_ll({"obs": jax_dt(obs_all, *plates)}).items()}

    with Env(**case.jenv):
        jpll, jd = jax_recorded(pipeline, jax.random.key(11), jax.random.key(2))
    aps, adata, acov = tml.load_all_data_covariates(3, M, N_FILMS, N_FILMS, "cpu")
    assert aps == all_ps
    np.testing.assert_array_equal(port_np(acov["x"], plates), x_all)
    f = predict.predictive_ll_fn(case.tprob, K, N, aps)
    state = case.tstates
    with Env(**case.tenv):
        tpll = f(*state, acov, adata, torch.Generator().manual_seed(0),
                 sample=case.ttree, noise=[g for g, _, _ in jd])
        # deterministic under the same generator
        gen = lambda: torch.Generator().manual_seed(4)
        one, two = f(*state, acov, adata, gen()), f(*state, acov, adata, gen())
    assert set(tpll) == set(jpll) == {"obs"}
    np.testing.assert_allclose(float(tpll["obs"]), float(jpll["obs"]), rtol=1e-5)
    assert float(one["obs"]) == float(two["obs"]) and np.isfinite(float(one["obs"]))


def test_importance_sample_fn_and_draw_errors():
    """``importance_sample_fn`` is deterministic under one generator; a draw
    without a generator or noise raises, and so does noise of the wrong
    shape or count."""
    tprob = port_movielens(tml.fake_data(seed=3, M=M, N=N_FILMS), grouped=True)
    f = predict.importance_sample_fn(tprob, K, N)
    state = (tprob.P.state(), tprob.Q.state())
    one = f(*state, torch.Generator().manual_seed(5))
    two = f(*state, torch.Generator().manual_seed(5))
    assert set(one) == {"mu_z", "psi_z", "z"}
    for k, v in one.items():
        assert v.dim_size("N") == N and torch.isfinite(v.data).all()
        assert torch.equal(v.data, two[k].data)
    s = tprob.sample(K, torch.Generator().manual_seed(0), reparam=False)
    with pytest.raises(ValueError, match="generator or"):
        s.importance_sample(N)
    # grouped: K_g is drawn at the root, (N, K), then K_z in plate_1
    root = np.zeros((N, K), np.float32)
    with pytest.raises(ValueError, match="ran out"):
        s.importance_sample(N, noise=[root])
    with pytest.raises(ValueError, match="shape"):
        s.importance_sample(N, noise=[np.zeros((N, K + 1), np.float32)])
    with pytest.raises(ValueError, match="more injected"):
        s.importance_sample(N, noise=[root, np.zeros((M, N, K), np.float32), root])


def test_timeseries_importance_sample_raises():
    """A plate that holds a Timeseries draws by FFBS (one joint route for
    AR(1)'s chain): its draws take injected Gumbel noise in draw order, the
    root's first, then the chain's last step and the steps T-2 down to 0,
    and the replay raises when that noise runs out or is left over."""
    prob = tar1.generate_problem("cpu")
    s = prob.sample(3, torch.Generator().manual_seed(0), reparam=False)
    with port_draws() as draws:
        isamp = s.importance_sample(10, torch.Generator().manual_seed(1))
    assert treduce._ffbs_routes == [("joint", ("K_ts",))]
    assert [tuple(g.shape) for g, _ in draws] == [(10, 3)] * (1 + tar1.T)
    assert set(isamp.dump()["ts"].dims) == {"T", "N"}
    noise = [g for g, _ in draws]
    with pytest.raises(ValueError, match="ran out"):
        s.importance_sample(10, noise=noise[:-1])
    with pytest.raises(ValueError, match="more injected"):
        s.importance_sample(10, noise=noise + noise[:1])


# ---- (e) the zoo oracles ---------------------------------------------------------

def linear_gaussian():
    """``tests/model_linear_gaussian.py`` in the port."""
    data = 1.5 + np.random.default_rng(0).standard_normal(10)
    P = Plate(a=Normal(2, 2), T=Plate(d=Normal(lambda a: 2.5 * a, 3)))
    Q = Plate(a=Normal(1, 4), T=Plate(d=Data()))
    moms = [("a", tmoments.mean), ("a", tmoments.mean2)]
    return P, Q, data, moms, 10000


def linear_gaussian_latents():
    """``tests/model_linear_gaussian_latents.py`` in the port."""
    data = 1.5 + np.random.default_rng(5).standard_normal(10)
    P = Plate(a=Normal(2, 2), T=Plate(z=Normal("a", 1.3), d=Normal("z", 1.5)))
    Q = Plate(a=Normal(1, 4), T=Plate(z=Normal(lambda a: 1.5 * a, 3.5), d=Data()))
    moms = [("a", tmoments.mean), ("a", tmoments.mean2),
            ("z", tmoments.mean), ("z", tmoments.mean2)]
    return P, Q, data, moms, 100


ZOO = {"model_linear_gaussian": linear_gaussian,
       "model_linear_gaussian_latents": linear_gaussian_latents}
IMPORTANCE_N = 1000


def zoo_problem(name):
    P, Q, data, moms, moment_K = ZOO[name]()
    ps = {"T": 10}
    prob = Problem(BoundPlate(P, ps, device="cpu"), BoundPlate(Q, ps, device="cpu"),
                   {"d": convert.dt_from_numpy(data, ("T",), "cpu")}, device="cpu")
    return prob, moms, moment_K


ZOO_CASES = list(itertools.product(ZOO, [True, False], samplers))


def _aligned_np(a, b):
    assert set(a.dims) == set(b.dims)
    return port_np(a, a.dims), port_np(b, a.dims)


@pytest.mark.parametrize("tp_name,reparam,sampler", ZOO_CASES)
def test_moments_sample_marginal(tp_name, reparam, sampler):
    """``marginals().moments`` equal ``Sample.moments`` (rtol 1e-4, atol
    1e-5), as ``tests/test_problem_vs_itself.py:87-96``, at K=3."""
    prob, moms, _ = zoo_problem(tp_name)
    gen = torch.Generator().manual_seed(1)
    sample = prob.sample(3, gen, reparam=reparam, sampler=sampler)
    marginals = sample.marginals()
    for varnames, moment in moms:
        sm, mm = _aligned_np(sample.moments(varnames, moment),
                             marginals.moments(varnames, moment))
        np.testing.assert_allclose(sm, mm, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tp_name,reparam,sampler", ZOO_CASES)
def test_moments_importance_sample(tp_name, reparam, sampler):
    """The importance samples' moments lie within 6 standard errors of the
    marginals', as ``tests/test_problem_vs_itself.py:99-116``."""
    prob, moms, moment_K = zoo_problem(tp_name)
    gen = torch.Generator().manual_seed(2)
    sample = prob.sample(moment_K, gen, reparam=reparam, sampler=sampler)
    marginals = sample.marginals()
    isamp = sample.importance_sample(IMPORTANCE_N, gen)
    for varnames, m in moms:
        mm = marginals.moments(varnames, m)
        im = isamp.moments(varnames, m)
        stderr = (marginals.moments(varnames, tmoments.var_from_raw_moment(m))
                  / IMPORTANCE_N).sqrt()
        v, lo = _aligned_np(im, mm - 6 * stderr)
        _, hi = _aligned_np(im, mm + 6 * stderr)
        assert np.all(lo < v) and np.all(v < hi), (lo, v, hi)


# ---- (f) the samplers, and the dims helpers --------------------------------------

def test_categorical_sampler_is_uniform():
    Kc, plates = 10, 4000
    perm = CategoricalSampler.perm(["p", "K_a"], "K_a", {"p": plates, "K_a": Kc},
                                   torch.Generator().manual_seed(0))
    assert perm.dims == ("p",) and perm.pos_shape == (Kc,)
    counts = np.bincount(perm.data.reshape(-1).numpy(), minlength=Kc)
    expected = plates * Kc / Kc
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < scipy.stats.chi2.ppf(0.999, Kc - 1), counts


def test_independent_sampler_is_the_identity():
    a = tdims.DT(torch.randn(6, 3), ("K_a", "p"))
    scope = IndependentSampler.resample_scope({"a": a}, ["p"], "K_b",
                                              {"K_b": 6, "p": 3},
                                              KeyGen(torch.Generator()))
    assert set(scope["a"].dims) == {"K_b", "p"}
    np.testing.assert_array_equal(port_np(scope["a"], ("K_b", "p")), a.data.numpy())
    lp = tdims.DT(torch.randn(6, 6), ("K_b", "K_a"))
    assert IndependentSampler.reduce_logQ(lp, [], "K_b") is lp
    assert samplers == [CategoricalSampler, PermutationSampler]


@pytest.mark.parametrize("grouped", [False, True])
def test_categorical_sampler_elbo_matches_jax(grouped):
    arrays = tml.fake_data(seed=3, M=M, N=N_FILMS)
    jprob, tprob = jax_movielens(arrays, grouped), port_movielens(arrays, grouped)
    gv2K = jprob.Q.plate.groupvarname2Kdim(K)
    jtree = jax.jit(lambda key: jprob.Q._sample(K, False, JCat, jprob.all_platedims,
                                                key)[0])(jax.random.key(9))
    jelbo = jax.jit(lambda: JSample(jprob, jtree, gv2K, JCat, False)
                    .elbo_nograd(j_no_checkpoint))()
    ttree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    telbo = Sample(tprob, ttree, gv2K, CategoricalSampler, False).elbo_nograd()
    np.testing.assert_allclose(float(telbo), float(jelbo), rtol=1e-5)


def test_dims_reductions_and_slice_match_jax():
    x = np.random.default_rng(0).uniform(0.5, 1.5, (3, 4, 5, 2)).astype(np.float32)
    j = jax_dt(x, "a", "b", "c")
    t = convert.dt_from_numpy(x, ("a", "b", "c"), "cpu")
    for jf, tf in ((jdims.prod_dims, tdims.prod_dims), (jdims.amax_dims, tdims.amax_dims),
                   (jdims.amin_dims, tdims.amin_dims)):
        for ds in (("b",), ("a", "c"), ("c", "a", "b")):
            assert_dt_close(jf(j, ds), tf(t, ds), 1e-6, 0)
    assert_dt_close(jdims.slice_dim(j, "b", 1, 3), tdims.slice_dim(t, "b", 1, 3), 0, 0)
