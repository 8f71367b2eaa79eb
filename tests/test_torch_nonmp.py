"""The port's non-MP global-K baseline (``sample_nonmp.py``,
``Problem.sample_nonmp``, ``train.global_vi`` / ``global_rws`` /
``global_qem``) against ``alan_tpu``'s, and the oracles of
``tests/test_nonmp.py`` in the port.

The three zoo models of ``tests/test_nonmp.py`` are built in both packages
from the same numpy data.  On the same draws (``alan_tpu``'s, drawn with its
``IndependentSampler`` and handed to the port) the joint log P/Q of every
particle and the ELBO agree to 1e-5 relative, the moments to 1e-4;
``alan_tpu``'s recorded Gumbel noise draws the same importance indices; one
step of each global method agrees at 1e-4.  ``alan_tpu``'s side runs under
``jax.jit`` (eager JAX compiles every op of a traversal).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu import mean as jmean
from alan_tpu import (BoundPlate as JBoundPlate, Data as JData, Normal as JNormal,
                      OptParam as JOptParam, Plate as JPlate, Problem as JProblem,
                      QEMParam as JQEMParam, named as jnamed, train as jtrain)
from alan_tpu.sample_nonmp import SampleNonMP as JSampleNonMP
from alan_tpu.sampler import IndependentSampler as JIndep
from alan_tpu_torch import (Bernoulli, Beta, BoundPlate, Data, Normal, OptParam, Plate,
                            Problem, QEMParam, SampleNonMP, Timeseries, convert, mean,
                            mean2, named, train)
from alan_tpu_torch.dims import as_dt, dims_of
from alan_tpu_torch.ir.plate import flatten_tree
from alan_tpu_torch.sample_nonmp import nonmp_moments_streaming
from alan_tpu_torch.utils import fold_seed, seeded_generator
from test_torch_harness import (assert_dt_close, assert_same_draws, assert_tree_close,
                                jax_recorded, port_draws, to_numpy_tree)
from test_torch_training import noise_of

MODELS = ["model_linear_gaussian", "model_bernoulli_no_plate",
          "model_linear_gaussian_latents"]
#: the port's moment of each of the zoo's moments, by name
PORT_MOMENTS = {"mean": mean, "mean2": mean2}


def _port_problem(name):
    """The port's build of the zoo model ``name`` on its data."""
    m = importlib.import_module(name)
    sizes = {"T": 10}
    if name == "model_linear_gaussian":
        P = Plate(a=Normal(m.prior_mean, m.prior_scale),
                  T=Plate(d=Normal(lambda a: m.mult * a, m.like_scale)))
        Q = Plate(a=Normal(1, 4), T=Plate(d=Data()))
        data = {"d": named(torch.tensor(m.data_np, dtype=torch.float32), "T")}
    elif name == "model_bernoulli_no_plate":
        P = Plate(p=Beta(2, 1), T=Plate(coin=Bernoulli("p")))
        Q = Plate(p=Beta(1, 1), T=Plate(coin=Data()))
        data = {"coin": named(torch.cat([torch.zeros(3), torch.ones(7)]), "T")}
    else:
        P = Plate(a=Normal(m.prior_mean, m.prior_scale),
                  T=Plate(z=Normal("a", m.z_scale), d=Normal("z", m.d_scale)))
        Q = Plate(a=Normal(1, 4), T=Plate(z=Normal(lambda a: 1.5 * a, 3.5), d=Data()))
        data = {"d": named(torch.tensor(m.data_np, dtype=torch.float32), "T")}
    return (m.tp, Problem(BoundPlate(P, sizes, device="cpu"),
                          BoundPlate(Q, sizes, device="cpu"), data, device="cpu"))


# ---- the oracles of tests/test_nonmp.py ----------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_nonmp_elbo_and_moments(name):
    tp, problem = _port_problem(name)
    s = problem.sample_nonmp(1000, torch.Generator().manual_seed(0))
    elbo = float(s.elbo_nograd())
    assert np.isfinite(elbo)
    if tp.known_elbo is not None:
        # the IWAE bound lies below the evidence, in its ballpark
        assert tp.known_elbo - 50.0 < elbo < tp.known_elbo + 1.0
    for varnames, m in tp.moments:
        mom = s._moments(varnames, PORT_MOMENTS[m.name])
        assert torch.isfinite(as_dt(mom).data).all()


def test_nonmp_importance_sample():
    tp, problem = _port_problem("model_linear_gaussian")
    s = problem.sample_nonmp(3000, torch.Generator().manual_seed(1))
    isamp = s.importance_sample(500, torch.Generator().manual_seed(2))
    mom = isamp.moments("a", mean)
    assert abs(float(mom.data) - float(tp.known_moments[("a", jmean)])) < 0.5


def test_nonmp_streaming_matches_global_softmax():
    """The chunked online log-sum-exp equals one global softmax over the
    same chunked proposals (chunk ``c`` from ``fold_seed(seed, c)``), and
    its ELBO the log-mean-exp of all of them."""
    tp, problem = _port_problem("model_linear_gaussian_latents")
    chunk, n_chunks, seed = 64, 4, 7
    moms = [(vns, PORT_MOMENTS[m.name]) for vns, m in tp.moments]
    got, elbo = nonmp_moments_streaming(problem, chunk * n_chunks, chunk, moms, seed)
    os_, fs = [], [[] for _ in moms]
    for c in range(n_chunks):
        s = problem.sample_nonmp(chunk, seeded_generator(fold_seed(seed, c), "cpu"),
                                 reparam=False)
        os_.append(s.logpq(s.detached_sample).order(s.Kdim).data)
        flat = flatten_tree(s.detached_sample)
        for i, (vns, m) in enumerate(moms):
            f = as_dt(m.f(*[flat[vn] for vn in vns])).with_dims_front([s.Kdim])
            fs[i].append(f)
    o = torch.cat(os_).double()
    w = torch.softmax(o, 0)
    assert abs(float(elbo) - float(torch.logsumexp(o, 0) - math.log(o.numel()))) <= 1e-4
    for i, g in enumerate(got):
        rest = list(fs[i][0].dims[1:])
        ref = torch.tensordot(w, torch.cat([f.data for f in fs[i]]).double(), dims=([0], [0]))
        np.testing.assert_allclose(g.with_dims_front(rest).data.numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        nonmp_moments_streaming(problem, 100, 64, moms, seed)


# ---- against alan_tpu, on its draws ---------------------------------------------

def _jax_tree(jprob, K, reparam, key, jstateQ=None):
    tree, gv2K = jprob.Q._sample(K, reparam, JIndep, jprob.all_platedims, key,
                                 state=jstateQ)
    return tree, gv2K


@pytest.mark.parametrize("name", MODELS)
def test_logpq_elbo_and_moments_match_jax(name):
    tp, tprob = _port_problem(name)
    jprob = tp.problem
    K, key = 50, jax.random.key(4)
    jtree, gv2K = _jax_tree(jprob, K, False, key)

    @jax.jit
    def jax_side(tree):
        s = JSampleNonMP(jprob, tree, gv2K, False)
        lpq = s.logpq(s.detached_sample)
        return (lpq, s.elbo_rws(), s.elbo_nograd(),
                [s._moments(vns, m) for vns, m in tp.moments])
    j_lpq, j_rws, j_nograd, j_moms = jax_side(jtree)
    ttree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    s = SampleNonMP(tprob, ttree, tprob.Q.plate.groupvarname2Kdim(K), False)
    t_lpq = s.logpq(s.detached_sample)
    assert dims_of(t_lpq) == ("K",)
    assert_dt_close(j_lpq, t_lpq, 1e-5, 1e-5 * float(np.abs(np.asarray(j_lpq.data)).max()))
    for j, t in ((j_rws, s.elbo_rws()), (j_nograd, s.elbo_nograd())):
        assert abs(float(t) - float(j)) <= 1e-5 * abs(float(j))
    for (vns, m), jm in zip(tp.moments, j_moms):
        assert_dt_close(jm, s._moments(vns, PORT_MOMENTS[m.name]), 1e-4, 1e-4)


@pytest.mark.parametrize("name", ["model_linear_gaussian", "model_linear_gaussian_latents"])
def test_importance_sample_matches_jax(name):
    """``alan_tpu``'s recorded Gumbel noise draws the same K indices in the
    port, and so the same importance sample."""
    tp, tprob = _port_problem(name)
    jprob = tp.problem
    K, N = 40, 30
    jtree, gv2K = _jax_tree(jprob, K, False, jax.random.key(5))

    def jax_side(tree, key):
        s = JSampleNonMP(jprob, tree, gv2K, False)
        return s.importance_sample(N, key).samples_flatdict
    j_samples, jdraws = jax_recorded(jax_side, jtree, jax.random.key(6))
    assert len(jdraws) == 1 and jdraws[0][0].shape == (N, K)
    ttree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    s = SampleNonMP(tprob, ttree, tprob.Q.plate.groupvarname2Kdim(K), False)
    with port_draws() as tdraws:
        isamp = s.importance_sample(N, noise=[torch.tensor(jdraws[0][0])])
    assert assert_same_draws(jdraws, tdraws) == 0
    for k, v in isamp.dump().items():
        assert_dt_close(j_samples[k], v, 1e-6, 1e-6)
    with pytest.raises(ValueError, match="generator"):
        s.importance_sample(N)


def _opt_latents(pkg):
    """``model_linear_gaussian_latents`` with an opt or a QEM Q, in one of
    the packages, for the global training steps."""
    m = importlib.import_module("model_linear_gaussian_latents")
    if pkg == "jax":
        Pl, No, Op, Qp, Da, BP, Pr, nm = (JPlate, JNormal, JOptParam, JQEMParam, JData,
                                          JBoundPlate, JProblem, jnamed)
        arr, exp, kw = jnp.asarray, jnp.exp, {}
    else:
        Pl, No, Op, Qp, Da, BP, Pr, nm = (Plate, Normal, OptParam, QEMParam, Data,
                                          BoundPlate, Problem, named)
        arr, exp, kw = torch.tensor, torch.exp, {"device": "cpu"}
    P = Pl(a=No(m.prior_mean, m.prior_scale),
           T=Pl(z=No("a", m.z_scale), d=No("z", m.d_scale)))
    out = {}
    out["opt"] = Pl(a=No(Op(1.0), Op(arr(math.log(4.0)), transformation=exp)),
                    T=Pl(z=No(Op(0.0), Op(arr(math.log(3.5)), transformation=exp)),
                         d=Da()))
    out["qem"] = Pl(a=No(Qp(1.0), Qp(4.0)), T=Pl(z=No(Qp(0.0), Qp(3.5)), d=Da()))
    data = {"d": nm(arr(m.data_np.astype(np.float32)), "T")}
    return {q: Pr(BP(P, {"T": 10}, **kw), BP(Q, {"T": 10}, **kw), data, **kw)
            for q, Q in out.items()}


@pytest.mark.parametrize("method", ["global_vi", "global_rws", "global_qem"])
def test_global_step_matches_jax(method):
    """One step of each global method on ``alan_tpu``'s draws: the ELBO and
    the new state at 1e-4."""
    qtype = "qem" if method == "global_qem" else "opt"
    jprob, tprob = _opt_latents("jax")[qtype], _opt_latents("port")[qtype]
    K, lr, key = 20, 0.05, jax.random.key(8)
    jstep, jstate = getattr(jtrain, method)(jprob, K, lr=lr)
    tstep, tstate = getattr(train, method)(tprob, K, lr=lr, device="cpu")
    jtree, _ = _jax_tree(jprob, K, method == "global_vi", key, jstate[1])
    if method == "global_vi":
        draws = {"generator": torch.Generator(), "noise": noise_of(jprob, jstate[1], jtree)}
    else:
        draws = {"sample": convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")}
    jnew, j_elbo = jstep(jstate, key)
    tnew, t_elbo = tstep(tstate, **draws)
    assert abs(float(t_elbo) - float(j_elbo)) <= 1e-4 * abs(float(j_elbo))
    groups = ("qem_params", "qem_means") if qtype == "qem" else ("opt",)
    for side in (0, 1):
        for g in groups:
            assert_tree_close(jnew[side][g], tnew[side][g], 1e-4, 1e-4)


def test_update_qem_params_matches_global_qem_step():
    """``SampleNonMP.update_qem_params`` writes into the BoundPlates the
    state that a ``global_qem`` step computes from the same particles."""
    tprob = _opt_latents("port")["qem"]
    step, state0 = train.global_qem(tprob, 15, lr=0.3, device="cpu")
    s = tprob.sample_nonmp(15, torch.Generator().manual_seed(3), reparam=False)
    tree = tprob.Q._sample(15, False, train.IndependentSampler, tprob.all_platedims,
                           torch.Generator().manual_seed(3))[0]
    (newP, newQ), _ = step(state0, sample=tree)
    s.update_qem_params(0.3)
    for new, bp in ((newP, tprob.P), (newQ, tprob.Q)):
        for g in ("qem_params", "qem_means"):
            for k, v in new[g].items():
                torch.testing.assert_close(bp.state()[g][k].data, v.data, rtol=0, atol=0)


def test_beta_draws_and_density():
    """The port's Beta: draws by two gammas, reparameterised, with the
    family's mean and variance; its log-density is ``alan_tpu``'s."""
    from alan_tpu.distributions.families import Beta as JBeta
    from alan_tpu_torch.distributions.families import Beta as TBeta
    a = torch.tensor(2.0, requires_grad=True)
    x = TBeta.sample(torch.Generator().manual_seed(0), (20000,),
                     {"concentration1": a, "concentration0": torch.tensor(3.0)})
    (g,) = torch.autograd.grad(x.mean(), [a])
    x = x.detach()
    assert x.min() > 0 and x.max() < 1
    m, v = 2 / 5, 2 * 3 / (25 * 6)
    assert abs(float(x.mean()) - m) < 4 * math.sqrt(v / 20000)
    assert abs(float(x.var()) - v) < 0.05 * v
    assert float(g) > 0
    xs = np.linspace(0.01, 0.99, 7, dtype=np.float32)
    p = {"concentration1": 2.5, "concentration0": 0.7}
    want = np.asarray(JBeta.log_prob(jnp.asarray(xs), p))
    got = TBeta.log_prob(torch.tensor(xs), {k: torch.tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_timeseries_has_no_global_path():
    P = Plate(init=Normal(0.0, 1.0),
              T=Plate(ts=Timeseries("init", Normal(lambda prev: prev, 1.0)),
                      d=Normal("ts", 1.0)))
    Q = Plate(init=Normal(0.0, 1.0), T=Plate(ts=Normal(0.0, 1.0), d=Data()))
    prob = Problem(BoundPlate(P, {"T": 3}, device="cpu"), BoundPlate(Q, {"T": 3}, device="cpu"),
                   {"d": named(torch.zeros(3), "T")}, device="cpu")
    s = prob.sample_nonmp(4, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="Timeseries"):
        s.elbo_nograd()
