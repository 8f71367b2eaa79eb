"""Covid with its ``corr_Q`` proposal (a QEM MultivariateNormal over the
nine NPI coefficients) in the port against ``alan_tpu``.

* One QEM step of a small covid (4 regions, 16 training days, counts of a
  few hundred, as ``tests/test_torch_timeseries.py``'s ``covid_setup``) from
  ``alan_tpu``'s particles, with the low-rank factored path forced in both
  packages as at full size: ELBO within 1e-5 relative, the moments (the MVN's
  ``mean`` and ``mean_xxT`` among them) and the updated QEM state (its 9 x 9
  covariance among them) within rtol/atol 1e-4; the chain runs through the
  small-K route, and the dense chain route gives the same step.
* ``convert.state_from_numpy`` carries ``alan_tpu``'s corr_Q state across,
  and the port builds the same initial state.
* ``corr_CM``'s prior is the factorised one: the same log-density.
* ``corr_Q`` with an opt Q raises in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu import named as jnamed
from alan_tpu.sample import Sample as JSample
from alan_tpu.sampler import PermutationSampler as JPerm
from alan_tpu.split import no_checkpoint as j_no_checkpoint
from alan_tpu_torch import convert, train
from alan_tpu_torch.dims import DT
from alan_tpu_torch.models import covid as tcovid
from alan_tpu_torch.ops import smallk_kernel as tsk
from alan_tpu_torch.sample import Sample
from alan_tpu_torch.sampler import PermutationSampler
from test_torch_harness import (Env, assert_dt_close, assert_tree_close, f64_chain_route,
                                joint_count, joint_shift_off, to_numpy_tree)

K, LR = 5, 0.3
#: the low-rank factored path forced in each package, as at full size
LOWRANK = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK=1)
_NM = ("nRs", "nDs")
_COV = (("ActiveCMs_NPIs", "npis"), ("ActiveCMs_wearing", "wearing"),
        ("ActiveCMs_mobility", "mobility"))


def _arrays():
    arrays = tcovid.fake_data(seed=4, nRs=4, nDs=20)
    arrays["obs"] = np.random.default_rng(4).poisson(300.0, (4, 20)).astype(np.float32)
    return arrays


def _inputs(arrays, pkg):
    if pkg == "jax":
        mk = lambda a: jnamed(jnp.asarray(a[:, :16]), *_NM)
    else:
        mk = lambda a: convert.dt_from_numpy(a[:, :16], _NM, "cpu")
    return {k: mk(arrays[a]) for k, a in _COV}, {"obs": mk(arrays["obs"])}


@pytest.fixture(scope="module")
def corrq():
    import covid as jcovid
    arrays = _arrays()
    ps = {"nRs": 4, "nDs": 16}
    jcov, jdata = _inputs(arrays, "jax")
    tcov, tdata = _inputs(arrays, "port")
    with Env(**LOWRANK):
        jprob = jcovid.generate_problem(ps, jdata, jcov, "qem", corr_Q=True)
        tprob = tcovid.generate_problem(ps, tdata, tcov, "qem", corr_Q=True, device="cpu")
    jtree = jax.jit(lambda key: jprob.Q._sample(K, False, JPerm, jprob.all_platedims,
                                                key)[0])(jax.random.key(3))
    return jprob, tprob, jtree


def _port_step(tprob, tree):
    """(ELBO, moments, updated Q state, ELBO of the step, segment calls) of
    one port QEM step from ``tree``."""
    calls = []
    orig = tsk.logmmexp_segment
    with Env(**LOWRANK):
        step, state = train.qem(tprob, K, lr=LR, device="cpu")
        ts = Sample(tprob, tree, tprob.Q.plate.groupvarname2Kdim(K),
                    PermutationSampler, False, states=state)
        t_elbo, t_moms = ts._moments_and_elbo(list(tprob.Q.qem_flat_list_rmkeys))
        try:
            tsk.logmmexp_segment = (lambda x, m: calls.append((tuple(x.shape), m))
                                    or orig(x, m))
            (_, t_newQ), t_elbo2 = step(state, sample=tree)
        finally:
            tsk.logmmexp_segment = orig
    return t_elbo, t_moms, t_newQ, t_elbo2, calls


def _assert_step_close(ref, got):
    """ELBO within 1e-5 relative; moments (the MVN's mean and mean_xxT among
    them) and the updated QEM state (its 9 x 9 covariance among them)
    within rtol/atol 1e-4."""
    (r_elbo, r_moms, r_newQ), (elbo, moms, newQ) = ref, got
    assert abs(float(elbo) - float(r_elbo)) <= 1e-5 * abs(float(r_elbo)), \
        (float(elbo), float(r_elbo))
    # 10 latents: the MVN's mean and mean_xxT, the Normals' mean and mean2
    assert len(moms) == len(r_moms) == 20
    assert [tuple(m.pos_shape) for m in moms[:2]] == [(9,), (9, 9)]
    for rm, m in zip(r_moms, moms):
        assert_dt_close(rm, m, 1e-4, 1e-4)
    for g in ("qem_params", "qem_means"):
        for k in r_newQ[g]:
            assert_dt_close(r_newQ[g][k], newQ[g][k], 1e-4, 1e-4)


def test_corrq_qem_step_matches_jax(corrq):
    """At Q's initial state the separate shifts of alan_tpu's chain
    log-matmul underflow on some entries, which the port takes with the
    joint shift (counted here): the port's step is held against the port
    with an exact float64 chain, and with the repair off against
    alan_tpu's."""
    jprob, tprob, jtree = corrq
    gv2K = jprob.Q.plate.groupvarname2Kdim(K)
    rmQ = list(jprob.Q.qem_flat_list_rmkeys)
    assert not jprob.P.qem_flat_list_rmkeys

    def jstep():
        stP, stQ = jprob.P.state(), jprob.Q.state()
        s = JSample(jprob, jtree, gv2K, JPerm, False, states=(stP, stQ))
        elbo, moms = s._moments_and_elbo(rmQ, j_no_checkpoint)
        return elbo, moms, jprob.Q._updated_qem_state(LR, s, j_no_checkpoint,
                                                       state=stQ, moments=moms)
    with Env(**LOWRANK):
        j_elbo, j_moms, j_newQ = jax.jit(jstep)()

    tree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    with joint_count() as joints:
        t_elbo, t_moms, t_newQ, t_elbo2, calls = _port_step(tprob, tree)
    # the chain ran through the small-K route: one launch of all four levels
    assert calls == [((4 * K, 16, K, K), 4)]
    assert float(t_elbo) == float(t_elbo2)
    assert int(joints) > 0
    with f64_chain_route():
        f_elbo, f_moms, f_newQ, _, _ = _port_step(tprob, tree)
    _assert_step_close((f_elbo, f_moms, f_newQ), (t_elbo, t_moms, t_newQ))
    with joint_shift_off():
        o_elbo, o_moms, o_newQ, _, _ = _port_step(tprob, tree)
    _assert_step_close((j_elbo, j_moms, j_newQ), (o_elbo, o_moms, o_newQ))
    cov = t_newQ["qem_params"]["CM_alpha_covariance_matrix"].data
    assert cov.shape == (9, 9) and bool(torch.isfinite(cov).all())
    assert int(torch.linalg.cholesky_ex(cov)[1]) == 0
    # the dense chain route gives the same step
    with Env(**LOWRANK):
        dense_step, state = train.qem(tprob, K, lr=LR, device="cpu")
        with Env(ALAN_TPU_NO_SMALLK_CHAIN=1):
            (_, d_newQ), d_elbo = dense_step(state, sample=tree)
    assert abs(float(d_elbo) - float(t_elbo)) <= 1e-6 * abs(float(t_elbo))
    for g in ("qem_params", "qem_means"):
        for k, v in d_newQ[g].items():
            w = t_newQ[g][k].with_dims_front(list(v.dims))
            torch.testing.assert_close(w.data, v.data, rtol=1e-5, atol=1e-5)


def test_corrq_state_carries_across(corrq):
    jprob, tprob, _ = corrq
    jstate = jprob.Q.state()
    carried = convert.state_from_numpy(to_numpy_tree(jstate), "cpu")
    assert_tree_close(jstate["qem_params"], carried["qem_params"], 0, 0)
    assert_tree_close(jstate["qem_means"], carried["qem_means"], 0, 0)
    own = tprob.Q.state()
    assert_tree_close(jstate["qem_params"], own["qem_params"], 0, 0)
    assert_tree_close(jstate["qem_means"], own["qem_means"], 1e-6, 1e-6)
    cov = own["qem_params"]["CM_alpha_covariance_matrix"]
    assert cov.dims == () and torch.equal(cov.data, torch.eye(9))
    assert own["qem_means"]["CM_alpha_mean_xxT"].pos_shape == (9, 9)


def test_corr_cm_prior_is_the_factorised_prior():
    """get_P(corr_CM=True) states CM_alpha's prior as N(0, I_9): its
    log-density of a draw equals the factorised prior's."""
    arrays = _arrays()
    cov, _ = _inputs(arrays, "port")
    ps = {"nRs": 4, "nDs": 16}
    x = DT(torch.from_numpy(np.random.default_rng(0).standard_normal((6, 9))
                            .astype(np.float32)), ("K_npis",))
    lps = []
    for corr in (False, True):
        P = tcovid.get_P(ps, cov, corr_CM=corr, device="cpu")
        dist = P.plate.flat_prog["CM_alpha"]
        lps.append(dist.log_prob(x, {}))
    assert lps[1].dims == ("K_npis",)
    torch.testing.assert_close(lps[1].data, lps[0].with_dims_front(["K_npis"]).data,
                               rtol=1e-5, atol=1e-5)


def test_corrq_needs_a_qem_q():
    import covid as jcovid
    arrays = _arrays()
    ps = {"nRs": 4, "nDs": 16}
    jcov, jdata = _inputs(arrays, "jax")
    tcov, tdata = _inputs(arrays, "port")
    with pytest.raises(ValueError, match="qem"):
        jcovid.generate_problem(ps, jdata, jcov, "opt", corr_Q=True)
    with pytest.raises(ValueError, match="qem"):
        tcovid.generate_problem(ps, tdata, tcov, "opt", corr_Q=True, device="cpu")
