"""The port's timeseries slice against ``alan_tpu``.

Inputs come from numpy seeds and go through both packages; the port runs on
the CPU (its kernels' plain versions).

* ``NegativeBinomial.log_prob``, ``Timeseries.log_prob`` and
  ``factor_components`` against their ``alan_tpu`` counterparts;
* one covid QEM step (nRs=4 regions, 16 training days, K=5) from the same
  injected Q draws, with the low-rank factored path forced in both packages
  so covid's cross-K ``log_infected`` factor takes the ``LowRankDT`` route it
  takes at full size: ELBO within 1e-5 relative, moments and the updated Q
  state within rtol/atol 1e-4, against the port with an exact float64 chain
  (at Q's initial state ``alan_tpu``'s chain underflows on some entries,
  which the port takes with the joint shift), and with the port's
  joint-shift repair off against ``alan_tpu``;
* the AR(1) model's ELBO at K=200 from the same draws: 1e-5 relative.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu import named as jnamed
from alan_tpu.distributions import families as jfam
from alan_tpu.ir.timeseries import Timeseries as JTimeseries
from alan_tpu.reduce_ks import factor_components as j_factor_components
from alan_tpu.sample import Sample as JSample
from alan_tpu.sampler import PermutationSampler as JPerm
from alan_tpu.split import no_checkpoint as j_no_checkpoint
from alan_tpu import Normal as JNormal
from alan_tpu_torch import Normal, Timeseries, convert, train
from alan_tpu_torch.distributions import families as tfam
from alan_tpu_torch.models import ar1 as tar1
from alan_tpu_torch.models import covid as tcovid
from alan_tpu_torch.ops import logmmexp_kernel as tlk
from alan_tpu_torch.ops import smallk_kernel as tsk
from alan_tpu_torch.reduce_ks import factor_components
from alan_tpu_torch.sample import Sample
from alan_tpu_torch.sampler import PermutationSampler
from test_torch_harness import (Env, assert_dt_close, f64_chain_route, jax_dt,
                                joint_count, joint_shift_off, to_numpy_tree)

#: the low-rank factored path forced in each package (covid's factor crosses
#: the 2^28 work threshold only at full size)
JAX_LOWRANK = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK=1)
PORT_LOWRANK = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK=1)


# ---- NegativeBinomial ---------------------------------------------------------

@pytest.mark.parametrize("param", ["probs", "logits"])
def test_negative_binomial_log_prob_matches_jax(param):
    """x = 0, small and large counts (up to 1e6).  Tolerance 1e-5 relative to
    the largest term of the sum, ``lgamma(x + r)``: float32 lgamma of XLA and
    of libm differ by up to an ulp, which at x = 1e6 is 1 in 1e7 of a term
    of 1.3e7 that the other terms cancel."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.zeros(8), rng.integers(1, 30, 24),
                        rng.integers(1000, 10 ** 6, 32)]).astype(np.float32)
    r = np.exp(rng.normal(0, 1, x.shape)).astype(np.float32)
    p = rng.uniform(0.05, 0.999, x.shape).astype(np.float32)
    theta = p if param == "probs" else np.log(p) - np.log1p(-p)
    want = np.asarray(jfam.NegativeBinomial.log_prob(
        jnp.asarray(x), {"total_count": jnp.asarray(r), param: jnp.asarray(theta)}))
    got = tfam.NegativeBinomial.log_prob(
        torch.from_numpy(x), {"total_count": torch.from_numpy(r),
                              param: torch.from_numpy(theta)}).numpy()
    scale = np.abs(want) + np.abs(torch.lgamma(torch.from_numpy(x + r)).numpy())
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-6), np.abs(got - want).max()
    assert np.all(np.isfinite(got))


def test_negative_binomial_sample_mean():
    """The Gamma-Poisson draw has mean r p / (1 - p)."""
    g = torch.Generator().manual_seed(0)
    r, p = torch.tensor(3.0), torch.tensor(0.4)
    x = tfam.NegativeBinomial.sample(g, (200000,), {"total_count": r, "probs": p})
    assert torch.all(x == x.round()) and torch.all(x >= 0)
    assert abs(float(x.mean()) - 2.0) < 0.03


# ---- Timeseries.log_prob ------------------------------------------------------

def test_timeseries_log_prob_matches_jax():
    """The lagged-sample factor of a transition with a plate dim beside T:
    dims T, Kinit, K and R, values 1e-5."""
    R, T, K = 3, 6, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((R, T, K)).astype(np.float32)
    init = rng.standard_normal((K, R)).astype(np.float32)
    out = {}
    for pkg, Ts, Nm, mk in (("jax", JTimeseries, JNormal, jax_dt),
                            ("port", Timeseries, Normal,
                             lambda a, *d: convert.dt_from_numpy(a, d, "cpu"))):
        ts = Ts("init", Nm(lambda prev: 0.9 * prev, 0.3))
        lp, kinit = ts.log_prob(mk(x, "R", "T", "K_ts"),
                                {"init": mk(init, "K_init", "R")}, "T", "K_ts")
        assert kinit == "K_init"
        out[pkg] = lp
    assert set(out["port"].dims) == {"R", "T", "K_ts", "K_init"}
    assert_dt_close(out["jax"], out["port"], 1e-5, 1e-5)


def test_timeseries_structure_checks():
    """The init must live in the parent plate, and a transition takes no
    learnable parameters, as in alan_tpu."""
    from alan_tpu_torch import BoundPlate, Plate, QEMParam
    P = Plate(a=Normal(0, 1),
              T=Plate(ts=Timeseries("b", Normal(lambda prev: prev, 1.0))))
    with pytest.raises(Exception, match="initializer"):
        BoundPlate(P, {"T": 3}, device="cpu")
    with pytest.raises(Exception, match="timeseries"):
        Timeseries("a", Normal(QEMParam(0.0), QEMParam(1.0)))


def test_timeseries_q_draws_and_prediction_raise():
    """The guards that stay now that K > 1 draws and the roll-forward are
    ported: the init must be named by a string, the transition must be a
    distribution without sample_shape, an init outside the parent plate
    raises at the draw, and covid's corr_Q (a MultivariateNormal proposal)
    raises without a QEM Q, as in alan_tpu."""
    with pytest.raises(Exception, match="string"):
        Timeseries(3, Normal(0, 1))
    with pytest.raises(Exception, match="distribution"):
        Timeseries("init", 0.5)
    with pytest.raises(Exception, match="sample_shape"):
        Timeseries("init", Normal(0, 1, sample_shape=[2]))
    ts = Timeseries("init", Normal(lambda prev: prev, 1.0))
    bad_init = convert.dt_from_numpy(np.zeros((4, 3), np.float32), ("K_ts", "T"), "cpu")
    with pytest.raises(Exception, match="one step up"):
        ts.sample({"init": bad_init}, torch.Generator(), False, ["T"], "K_ts",
                  {"T": 3, "K_ts": 4})
    ps, _, data, _, cov, _ = tcovid.load_data_covariates(1, nRs=2, nDs=5, device="cpu")
    with pytest.raises(ValueError, match="Q_param_type='qem'"):
        tcovid.generate_problem(ps, data, cov, corr_Q=True, device="cpu")


# ---- factor_components --------------------------------------------------------

LAYOUTS = [
    # three independent chains in one plate (tests/model_indep_timeseries.py)
    ([("T", "K_a", "K_a0"), ("T", "K_b", "K_b0"), ("T", "K_c", "K_c0"),
      ("T", "K_a"), ("T", "K_b"), ("T", "K_c")], {"K_a", "K_b", "K_c"}),
    # two chains coupled by one observation (tests/model_double_timeseries.py)
    ([("T", "K_x", "K_x0"), ("T", "K_y", "K_y0"), ("T", "K_x", "K_y")],
     {"K_x", "K_y"}),
    # covid's plate: source terms, the chain factor, the observations
    ([("nRs", "nDs", "K_li"), ("nRs", "nDs", "K_li", "K_npis", "K_a"),
      ("nRs", "nDs", "K_li", "K_a")], {"K_li"}),
    # a factor with no eliminated dim stands alone
    ([("T",), ("T", "K_a"), ("K_b",)], {"K_a"}),
]


@pytest.mark.parametrize("dims,elim", LAYOUTS)
def test_factor_components_matches_jax(dims, elim):
    got = factor_components(dims, elim)
    want = j_factor_components(dims, elim)
    assert got == want
    assert sorted(i for idxs, _ in got for i in idxs) == list(range(len(dims)))


def test_factor_components_random_layouts():
    rng = np.random.default_rng(5)
    names = [f"K_{i}" for i in range(8)]
    for _ in range(50):
        dims = [tuple(rng.choice(names, rng.integers(0, 4), replace=False))
                for _ in range(rng.integers(1, 9))]
        elim = set(rng.choice(names, rng.integers(0, 6), replace=False))
        assert factor_components(dims, elim) == j_factor_components(dims, elim)


# ---- covid: one QEM step ------------------------------------------------------

COVID_K, COVID_LR = 5, 0.3


def jax_covid(arrays, nDs_train):
    import covid as jcovid
    nRs = arrays["obs"].shape[0]
    nm = ("nRs", "nDs")
    cut = lambda a: jnp.asarray(a[:, :nDs_train])
    cov = {"ActiveCMs_NPIs": jnamed(cut(arrays["npis"]), *nm),
           "ActiveCMs_wearing": jnamed(cut(arrays["wearing"]), *nm),
           "ActiveCMs_mobility": jnamed(cut(arrays["mobility"]), *nm)}
    data = {"obs": jnamed(cut(arrays["obs"]), *nm)}
    return jcovid.generate_problem({"nRs": nRs, "nDs": nDs_train}, data, cov, "qem")


@pytest.fixture(scope="module")
def covid_setup():
    """Covid at 4 regions x 16 training days, the recipe's covariates and
    counts of a few hundred.  The recipe's own counts reach 1e7 within a
    week, where ``probs`` sits within a few float32 ulps of 1: an ulp of
    ``probs`` (6e-8) times a count of 1e7 moves an observation's
    log-density by ~0.5 nats, and XLA and PyTorch round ``probs``
    differently (52 nats of 1.4e5 in the ELBO at this size, the
    ``log_infected`` factor agreeing to 3e-8)."""
    arrays = tcovid.fake_data(seed=4, nRs=4, nDs=20)
    arrays["obs"] = np.random.default_rng(4).poisson(300.0, (4, 20)).astype(np.float32)
    ps = {"nRs": 4, "nDs": 16}
    cut = lambda a: convert.dt_from_numpy(a[:, :16], ("nRs", "nDs"), "cpu")
    cov = {"ActiveCMs_NPIs": cut(arrays["npis"]),
           "ActiveCMs_wearing": cut(arrays["wearing"]),
           "ActiveCMs_mobility": cut(arrays["mobility"])}
    data = {"obs": cut(arrays["obs"])}
    with Env(**JAX_LOWRANK):
        jprob = jax_covid(arrays, 16)
    with Env(**PORT_LOWRANK):
        tprob = tcovid.generate_problem(ps, data, cov, "qem", device="cpu")
    jtree, _ = jprob.Q._sample(COVID_K, False, JPerm, jprob.all_platedims,
                               jax.random.key(3))
    return jprob, tprob, jtree


def test_covid_fake_data_follows_the_recipe():
    a = tcovid.fake_data(seed=0, nRs=6, nDs=30)
    assert a["npis"].shape == (6, 30, tcovid.nCMs - 2)
    assert set(np.unique(a["npis"])) <= {0.0, 1.0}
    assert a["obs"].shape == (6, 30) and np.all(a["obs"] >= 0)
    assert np.all((a["wearing"] >= 0) & (a["wearing"] < 1))
    assert a["log_infected"].shape == (6, 30)
    # the recursion: each day's mean adds the previous day's value
    assert np.all(a["log_infected"][:, -1] > a["log_infected"][:, 0])


def _port_covid_qem_step(tprob, tree):
    """(ELBO, moments, updated Q state, ELBO of the step, segment calls) of
    one port QEM step from ``tree``."""
    calls = []
    orig = tsk.logmmexp_segment
    with Env(**PORT_LOWRANK):
        step, state = train.qem(tprob, COVID_K, lr=COVID_LR, device="cpu")
        ts = Sample(tprob, tree, tprob.Q.plate.groupvarname2Kdim(COVID_K),
                    PermutationSampler, False, states=state)
        t_elbo, t_moms = ts._moments_and_elbo(list(tprob.Q.qem_flat_list_rmkeys))
        try:
            tsk.logmmexp_segment = (lambda x, m: calls.append((tuple(x.shape), m))
                                    or orig(x, m))
            (_, t_newQ), t_elbo2 = step(state, sample=tree)
        finally:
            tsk.logmmexp_segment = orig
    return t_elbo, t_moms, t_newQ, t_elbo2, calls


def _assert_step_close(ref_elbo, ref_moms, ref_newQ, elbo, moms, newQ):
    """ELBO within 1e-5 relative, moments and the updated state within
    rtol/atol 1e-4; the reference's moments and state may be JAX's or the
    port's DTs."""
    assert abs(float(elbo) - float(ref_elbo)) <= 1e-5 * abs(float(ref_elbo)), \
        (float(elbo), float(ref_elbo))
    assert len(moms) == len(ref_moms) == 20    # 10 latents: mean, mean2
    for rm, m in zip(ref_moms, moms):
        assert_dt_close(rm, m, 1e-4, 1e-4)
    for group in ("qem_params", "qem_means"):
        for k in ref_newQ[group]:
            assert_dt_close(ref_newQ[group][k], newQ[group][k], 1e-4, 1e-4)


def test_covid_qem_step_matches_jax(covid_setup):
    """One QEM step from alan_tpu's particles at Q's initial state.  There
    the separate shifts of alan_tpu's chain log-matmul underflow on some
    entries (every term below FLT_MIN); the port takes those entries with
    the joint shift (counted here), so its step is held against the port
    with an exact float64 chain, and with the repair off against alan_tpu."""
    jprob, tprob, jtree = covid_setup
    with Env(**JAX_LOWRANK):
        stP, stQ = jprob.P.state(), jprob.Q.state()
        s = JSample(jprob, jtree, jprob.Q.plate.groupvarname2Kdim(COVID_K), JPerm,
                    False, states=(stP, stQ))
        rmQ = jprob.Q.qem_flat_list_rmkeys
        assert not jprob.P.qem_flat_list_rmkeys
        j_elbo, j_moms = s._moments_and_elbo(list(rmQ), j_no_checkpoint)
        j_newQ = jprob.Q._updated_qem_state(COVID_LR, s, j_no_checkpoint,
                                            state=stQ, moments=j_moms)

    tree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    fwd = tsk.FWD_LAUNCHES
    with joint_count() as joints:
        t_elbo, t_moms, t_newQ, t_elbo2, calls = _port_covid_qem_step(tprob, tree)
    # the chain ran through the small-K route, one launch per entry of the
    # launch plan: at T = 16 and K = 5 one launch of all four levels, over
    # nRs * K chains; on the CPU no kernel launches
    assert tsk.launch_plan(16, COVID_K) == [4]
    assert calls == [((4 * COVID_K, 16, COVID_K, COVID_K), 4)]
    assert tsk.FWD_LAUNCHES == fwd
    assert float(t_elbo) == float(t_elbo2)
    assert int(joints) > 0
    with f64_chain_route():
        f_elbo, f_moms, f_newQ, _, f_calls = _port_covid_qem_step(tprob, tree)
    assert f_calls == []
    _assert_step_close(f_elbo, f_moms, f_newQ, t_elbo, t_moms, t_newQ)
    with joint_shift_off():
        o_elbo, o_moms, o_newQ, _, _ = _port_covid_qem_step(tprob, tree)
    _assert_step_close(j_elbo, j_moms, j_newQ, o_elbo, o_moms, o_newQ)


def test_covid_chain_routes_agree(covid_setup):
    """The port's small-K route and its dense route give the same step."""
    _, tprob, jtree = covid_setup
    tree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    out = {}
    for name, env in (("smallk", PORT_LOWRANK),
                      ("dense", dict(PORT_LOWRANK, ALAN_TPU_NO_SMALLK_CHAIN=1))):
        with Env(**env):
            step, state = train.qem(tprob, COVID_K, lr=COVID_LR, device="cpu")
            out[name] = step(state, sample=tree)
    (_, qS), eS = out["smallk"]
    (_, qD), eD = out["dense"]
    assert abs(float(eS) - float(eD)) <= 1e-6 * abs(float(eD))
    for group in ("qem_params", "qem_means"):
        for k, v in qD[group].items():
            w = qS[group][k].with_dims_front(list(v.dims))
            torch.testing.assert_close(w.data, v.data, rtol=1e-5, atol=1e-5)


def test_covid_prior_draw_runs_the_timeseries():
    """BoundPlate.sample draws log_infected day by day from its transition."""
    ps, _, _, _, cov, _ = tcovid.load_data_covariates(1, nRs=3, nDs=10, device="cpu")
    P = tcovid.get_P(ps, cov, device="cpu")
    draw = P.sample(torch.Generator().manual_seed(2))
    li = draw["log_infected"].with_dims_front(["nRs", "nDs"]).data
    assert li.shape == (3, 8) and torch.isfinite(li).all()
    assert set(draw["obs"].dims) == {"nRs", "nDs"}


# ---- AR(1): the ELBO at K=200 ---------------------------------------------------

def test_ar1_elbo_matches_jax():
    import model_timeseries as jar1
    assert np.allclose(np.asarray(jar1.data["obs"].data), tar1.data_ts, atol=1e-6)
    assert math.isclose(jar1.known_elbo, tar1.known_elbo, rel_tol=1e-6)
    K = 200
    jprob = jar1.tp.problem
    jtree, _ = jprob.Q._sample(K, False, JPerm, jprob.all_platedims, jax.random.key(9))
    j_elbo = float(JSample(jprob, jtree, jprob.Q.plate.groupvarname2Kdim(K),
                           JPerm, False).elbo_nograd())
    tprob = tar1.generate_problem("cpu")
    tree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    launches = tlk.LAUNCHES
    t_elbo = float(Sample(tprob, tree, tprob.Q.plate.groupvarname2Kdim(K),
                          PermutationSampler, False).elbo_nograd())
    assert tlk.LAUNCHES == launches
    assert abs(t_elbo - j_elbo) <= 1e-5 * abs(j_elbo), (t_elbo, j_elbo)
    assert abs(t_elbo - tar1.known_elbo) < 1.0
