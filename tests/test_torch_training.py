"""The port's OptParam state, VI, RWS and ``fit`` against ``alan_tpu``.

Both packages get the same numpy inputs and the same draws.  RWS takes
``alan_tpu``'s detached particle tree; VI takes the standard noise of
``alan_tpu``'s reparameterised draws, ``(z - loc) / scale`` at its Q
params, from which the port rebuilds each draw under autograd
(``step(state, noise=tree)``).  The port runs on the CPU.

* The OptParam state: ``state()["opt"]`` and ``opt_params()`` equal
  ``alan_tpu``'s to 1e-6 on the conjugate model of ``tests/test_training.py``,
  a model with ``extra_opt_params`` and a P-side OptParam, small MovieLens
  (ungrouped and grouped) and small covid.
* The ELBO (1e-5 relative) and its gradient with respect to every opt param
  (rtol/atol 1e-4, as ``tests/test_lowrank_lazy.py:57-67``), VI and RWS, on
  the conjugate model, small MovieLens ungrouped, small MovieLens grouped
  with the lazy low-rank route forced (its gradients reach both factored
  operands, U and V) and small covid through the small-K chain route (where
  ``alan_tpu``'s chain underflows on some entries: the port against itself
  with an exact float64 chain, and with its joint-shift repair off against
  ``alan_tpu``).
* Three VI and three RWS steps against ``alan_tpu``'s ``optax.adam`` steps:
  the opt state to rtol/atol 1e-4.
* The port's counterparts of ``test_vi_converges_to_posterior`` and
  ``test_rws_converges_to_posterior`` (``tests/test_training.py:52-73``),
  with the same K, iterations, lr and thresholds.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu import (BoundPlate as JBoundPlate, Data as JData, Group as JGroup,
                      Normal as JNormal, OptParam as JOptParam, Plate as JPlate,
                      Problem as JProblem, named as jnamed, train as jtrain)
from alan_tpu.sampler import PermutationSampler as JPerm
from alan_tpu_torch import (BoundPlate, Data, Normal, OptParam, Plate, Problem,
                            convert, named, train)
from alan_tpu_torch.dims import DT
from alan_tpu_torch.models import covid as tcovid
from alan_tpu_torch.models import movielens as tml
from alan_tpu_torch.ops import lowrank as tlr
from alan_tpu_torch.ops import smallk_kernel as tsk
from test_torch_harness import (Env, assert_tree_close, f64_chain_route, jax_dt, joint_count,
                                joint_shift_off, to_numpy_tree)

PRIOR_MEAN, PRIOR_SCALE, LIKE_SCALE, N = 2.0, 2.0, 3.0, 10

#: the lazy low-rank route forced in the port; alan_tpu, under the same
#: knobs on the CPU, evaluates the same factored form densely
LAZY = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK_MIN=1)
#: the factored form for covid's cross-K log_infected factor, as at full size
COVID_LOWRANK = dict(ALAN_TPU_LOWRANK_MIN=1, ALAN_TPU_LAZY_LOWRANK=1)


# ---- the models, in both packages ---------------------------------------------

def _conjugate_data():
    rng = np.random.default_rng(42)
    return 1.5 + rng.standard_normal(N).astype(np.float32)


def conjugate(extra=False):
    """The conjugate model of ``tests/test_training.py:16-41`` in both
    packages; ``extra`` adds a P-side OptParam (the prior's location) and
    two ``extra_opt_params`` of P (the likelihood's log-scale, and a
    per-datum offset along the plate)."""
    d = _conjugate_data()
    off = (0.1 * np.arange(N)).astype(np.float32)
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            Pl, No, Op, Da, BP, Pr = JPlate, JNormal, JOptParam, JData, JBoundPlate, JProblem
            arr, exp, nm, kw = jnp.asarray, jnp.exp, jnamed, {}
        else:
            Pl, No, Op, Da, BP, Pr = Plate, Normal, OptParam, Data, BoundPlate, Problem
            arr, exp, nm, kw = torch.tensor, torch.exp, named, {"device": "cpu"}
        if extra:
            P = Pl(a=No(Op(1.0, name="a_prior_loc"), PRIOR_SCALE),
                   T=Pl(d=No(lambda a, off: a + off,
                             lambda log_like_scale: log_like_scale.exp())))
            extra_opt = {"log_like_scale": arr(math.log(LIKE_SCALE)),
                         "off": nm(arr(off), "T")}
        else:
            P = Pl(a=No(PRIOR_MEAN, PRIOR_SCALE), T=Pl(d=No("a", LIKE_SCALE)))
            extra_opt = None
        Q = Pl(a=No(Op(0.0), Op(arr(math.log(4.0)), transformation=exp)),
               T=Pl(d=Da()))
        Pb = BP(P, {"T": N}, extra_opt_params=extra_opt, **kw)
        Qb = BP(Q, {"T": N}, **kw)
        out.append(Pr(Pb, Qb, {"d": nm(arr(d), "T")}, **kw))
    return out


def movielens(grouped, M=12, N_films=3):
    import movielens as jml
    arrays = tml.fake_data(seed=3, M=M, N=N_films)
    ps = {"plate_1": M, "plate_2": N_films}
    plates = ("plate_1", "plate_2")
    jcov = {"x": jax_dt(arrays["x"], *plates)}
    jdata = {"obs": jax_dt(arrays["obs"], *plates)}
    if grouped:
        d_z = jml.d_z
        qn = lambda: JNormal(JOptParam(jnp.zeros(d_z)),
                             JOptParam(jnp.zeros(d_z), transformation=jnp.exp))
        Q = JPlate(g=JGroup(mu_z=qn(), psi_z=qn()),
                   plate_1=JPlate(z=qn(), plate_2=JPlate(obs=JData())))
        jprob = JProblem(jml.get_P(ps, jcov), JBoundPlate(Q, ps, inputs=jcov), jdata)
    else:
        jprob = jml.generate_problem(ps, jdata, jcov, "opt")
    tcov = {"x": convert.dt_from_numpy(arrays["x"], plates, "cpu")}
    tdata = {"obs": convert.dt_from_numpy(arrays["obs"], plates, "cpu")}
    build = tml.grouped_problem if grouped else tml.generate_problem
    return jprob, build(ps, tdata, tcov, "opt", device="cpu")


def covid(nRs=3, nDs=12, nDs_train=10):
    """Covid with its opt Q, the recipe's covariates and counts of a few
    hundred (``tests/test_torch_timeseries.py``'s ``covid_setup`` says why)."""
    import covid as jcovid
    arrays = tcovid.fake_data(seed=4, nRs=nRs, nDs=nDs)
    arrays["obs"] = np.random.default_rng(4).poisson(300.0, (nRs, nDs)).astype(np.float32)
    ps = {"nRs": nRs, "nDs": nDs_train}
    nm = ("nRs", "nDs")
    keys = (("ActiveCMs_NPIs", "npis"), ("ActiveCMs_wearing", "wearing"),
            ("ActiveCMs_mobility", "mobility"))
    jcov = {k: jax_dt(arrays[a][:, :nDs_train], *nm) for k, a in keys}
    tcov = {k: convert.dt_from_numpy(arrays[a][:, :nDs_train], nm, "cpu") for k, a in keys}
    jdata = {"obs": jax_dt(arrays["obs"][:, :nDs_train], *nm)}
    tdata = {"obs": convert.dt_from_numpy(arrays["obs"][:, :nDs_train], nm, "cpu")}
    with Env(**COVID_LOWRANK):
        return (jcovid.generate_problem(ps, jdata, jcov, "opt"),
                tcovid.generate_problem(ps, tdata, tcov, device="cpu"))


MODELS = {
    "conjugate": (lambda: conjugate(), 3, {}),
    "movielens": (lambda: movielens(False), 4, {}),
    "movielens_grouped_lazy": (lambda: movielens(True), 6, LAZY),
    "covid": (covid, 3, COVID_LOWRANK),
}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    build, K, env = MODELS[request.param]
    jprob, tprob = build()
    return request.param, jprob, tprob, K, env


# ---- injected draws -------------------------------------------------------------

def noise_of(jprob, jstateQ, jtree):
    """The standard noise of ``alan_tpu``'s reparameterised draws ``jtree``:
    ``(z - loc) / scale`` of each latent at its Q params, as port DTs."""
    opt = convert.tree_from_numpy(to_numpy_tree(jprob.Q.opt_params(jstateQ)), "cpu")

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif v is not None:
                z = convert.tree_from_numpy(to_numpy_tree(v), "cpu")
                out[k] = (z - opt[f"{k}_loc"]) / opt[f"{k}_scale"]
        return out
    return walk(jtree)


def jax_draws(jprob, K, reparam, key, jstateQ):
    tree, _ = jprob.Q._sample(K, reparam, JPerm, jprob.all_platedims, key, state=jstateQ)
    if reparam:
        return {"noise": noise_of(jprob, jstateQ, tree)}
    return {"sample": convert.tree_from_numpy(to_numpy_tree(tree), "cpu")}


# ---- the OptParam state -----------------------------------------------------------

@pytest.mark.parametrize("name", ["extra"])
def test_extra_opt_params_state_matches_jax(name):
    jprob, tprob = conjugate(extra=True)
    _check_state(jprob, tprob)
    assert set(tprob.P.state()["opt"]) == {"log_like_scale", "off", "a_prior_loc"}
    assert tprob.P.state()["opt"]["off"].dims == ("T",)


def _check_state(jprob, tprob):
    for jb, tb in ((jprob.P, tprob.P), (jprob.Q, tprob.Q)):
        jopt = jb.state()["opt"]
        assert list(tb.state()["opt"]) == list(jopt)
        assert_tree_close(jopt, tb.state()["opt"], 1e-6, 1e-6)
        assert_tree_close(jb.opt_params(), tb.opt_params(), 1e-6, 1e-6)
        # convert carries alan_tpu's state, opt params included, across
        carried = convert.state_from_numpy(to_numpy_tree(jb.state()), "cpu")
        assert_tree_close(jopt, carried["opt"], 0, 0)
    assert tprob.Q.state()["opt"], "the Q of every model here has opt params"


def test_opt_state_matches_jax(model):
    _, jprob, tprob, _, _ = model
    _check_state(jprob, tprob)


def test_opt_param_name_clash_raises():
    P = Plate(a=Normal(OptParam(0.0), 1.0))
    with pytest.raises(Exception, match="clash"):
        BoundPlate(P, {}, extra_opt_params={"a_loc": torch.tensor(1.0)}, device="cpu")


# ---- ELBO and gradients -------------------------------------------------------------

def _jax_elbo_and_grads(jprob, K, reparam, key):
    f = jtrain.elbo_fn(jprob, K, reparam)
    stP, stQ = jprob.P.state(), jprob.Q.state()

    def elbo(params):
        return f({**stP, "opt": params["P"]}, {**stQ, "opt": params["Q"]}, key)
    value, grads = jax.jit(jax.value_and_grad(elbo))({"P": stP["opt"], "Q": stQ["opt"]})
    return float(value), grads


def _port_elbo_and_grads(tprob, K, reparam, draws):
    f = train.elbo_fn(tprob, K, reparam)
    leaves, sP, sQ = train.opt_leaves(tprob.P.state(), tprob.Q.state())
    elbo = f(sP, sQ, **draws)
    grads = iter(torch.autograd.grad(elbo, leaves))
    return float(elbo.detach()), {side: {k: DT(next(grads), v.dims) for k, v in s["opt"].items()}
                         for side, s in (("P", sP), ("Q", sQ))}


def _assert_grads_close(ref_elbo, ref_grads, elbo, grads):
    """The ELBO within 1e-5 relative, every gradient within rtol/atol
    1e-4; the reference is alan_tpu's or the port's."""
    assert abs(elbo - ref_elbo) <= 1e-5 * abs(ref_elbo), (elbo, ref_elbo)
    for side in ("P", "Q"):
        assert_tree_close(ref_grads[side], grads[side], 1e-4, 1e-4)


@pytest.mark.parametrize("method", ["vi", "rws"])
def test_elbo_and_gradients_match_jax(model, method):
    """Covid at Q's initial state: ``alan_tpu``'s chain log-matmul
    underflows on some entries, which the port takes with the joint shift
    (counted); its ELBO and gradients are held against the port with an
    exact float64 chain, and with the repair off against ``alan_tpu``'s.
    On the other models no entry takes the joint shift."""
    name, jprob, tprob, K, env = model
    reparam = method == "vi"
    key = jax.random.key(7)
    spy, chain = [], []
    kernel, segment = tlr.lowrank_logsumexp, tsk.logmmexp_segment

    def contract(U, V, D):
        spy.append((U.requires_grad, V.requires_grad))
        return kernel(U, V, D)

    def chain_segment(x, m):
        chain.append((tuple(x.shape), x.requires_grad))
        return segment(x, m)
    with Env(**env):
        j_elbo, j_grads = _jax_elbo_and_grads(jprob, K, reparam, key)
        draws = jax_draws(jprob, K, reparam, key, jprob.Q.state())
        tlr.lowrank_logsumexp, tsk.logmmexp_segment = contract, chain_segment
        try:
            with joint_count() as joints:
                t_elbo, t_grads = _port_elbo_and_grads(tprob, K, reparam, draws)
        finally:
            tlr.lowrank_logsumexp, tsk.logmmexp_segment = kernel, segment
    if name == "covid":
        assert int(joints) > 0
        with Env(**env), f64_chain_route():
            f_elbo, f_grads = _port_elbo_and_grads(tprob, K, reparam, draws)
        _assert_grads_close(f_elbo, f_grads, t_elbo, t_grads)
        with Env(**env), joint_shift_off():
            o_elbo, o_grads = _port_elbo_and_grads(tprob, K, reparam, draws)
        _assert_grads_close(j_elbo, j_grads, o_elbo, o_grads)
    else:
        assert int(joints) == 0
        _assert_grads_close(j_elbo, j_grads, t_elbo, t_grads)
    if name == "movielens_grouped_lazy":
        # z's factor ran through the lazy contraction, and under VI both of
        # its operands carry a gradient: z's draw in U, mu_z's and psi_z's in V
        assert spy == [(reparam, reparam)]
    elif name != "covid":
        assert spy == []
    # covid's log_infected chain ran through the small-K route, under
    # autograd: one launch of all its levels over nRs * K chains of T = 10
    assert chain == ([((3 * K, 10, K, K), True)] if name == "covid" else [])


# ---- steps against optax ------------------------------------------------------------

@pytest.mark.parametrize("name", ["conjugate", "movielens_grouped_lazy"])
@pytest.mark.parametrize("method", ["vi", "rws"])
def test_three_steps_match_optax(name, method):
    build, K, env = MODELS[name]
    jprob, tprob = build()
    lr = 0.05
    with Env(**env):
        jstep, jstate = getattr(jtrain, method)(jprob, K, lr=lr)
        tstep, tstate = getattr(train, method)(tprob, K, lr=lr, device="cpu")
        first = tstate
        for i in range(3):
            key = jax.random.key(20 + i)
            draws = jax_draws(jprob, K, method == "vi", key, jstate[1])
            jstate, j_elbo = jstep(jstate, key)
            tstate, t_elbo = tstep(tstate, **draws)
            assert abs(float(t_elbo) - float(j_elbo)) <= 1e-5 * abs(float(j_elbo))
    for side in (0, 1):
        assert_tree_close(jstate[side]["opt"], tstate[side]["opt"], 1e-4, 1e-4)
    # the steps left the state they were given untouched
    assert_tree_close(jprob.Q.state()["opt"], first[1]["opt"], 0, 0)
    assert int(tstate[2]["state"][0]["step"]) == 3


def test_steps_run_from_a_generator():
    """The generator path: finite ELBOs, the opt params move, and a fixed
    seed repeats the step."""
    _, tprob = movielens(True)
    for method in ("vi", "rws"):
        step, state = getattr(train, method)(tprob, 5, device="cpu")
        out = [step(state, torch.Generator().manual_seed(1)) for _ in range(2)]
        (s1, e1), (s2, e2) = out
        assert np.isfinite(float(e1)) and float(e1) == float(e2)
        assert_tree_close(s1[1]["opt"], s2[1]["opt"], 0, 0)
        moved = s1[1]["opt"]["z_loc"].data - state[1]["opt"]["z_loc"].data
        assert moved.abs().max() > 0
    with pytest.raises(ValueError):
        step(state)


def test_noise_needs_a_generator_for_permutations():
    """Injected noise replaces the standard noise only: where Q permutes a
    parent's particles, a step given noise and no generator raises (it
    does not pick permutations of its own); with a generator it runs."""
    P = Plate(a=Normal(0.0, 1.0), b=Normal("a", 1.0), T=Plate(d=Normal("b", 1.0)))
    Q = Plate(a=Normal(OptParam(0.0), 1.0), b=Normal("a", 1.0), T=Plate(d=Data()))
    d = named(torch.tensor(_conjugate_data()), "T")
    prob = Problem(BoundPlate(P, {"T": N}, device="cpu"), BoundPlate(Q, {"T": N}, device="cpu"),
                   {"d": d}, device="cpu")
    K = 3
    kdims = prob.Q.plate.groupvarname2Kdim(K)
    rng = np.random.default_rng(0)
    noise = {v: DT(torch.tensor(rng.standard_normal(K).astype(np.float32)), (kdims[v],))
             for v in ("a", "b")}
    noise["T"] = {}
    step, state = train.vi(prob, K, device="cpu")
    with pytest.raises(ValueError, match="needs a generator"):
        step(state, noise=noise)
    _, elbo = step(state, torch.Generator().manual_seed(0), noise=noise)
    assert np.isfinite(float(elbo))


def test_sample_elbo_forms():
    """``elbo_vi`` differentiates through the draws, ``elbo_rws`` does not,
    and a detached sample refuses ``elbo_vi``."""
    _, tprob = conjugate()
    loc = tprob.Q.state()["opt"]["a_loc"].data.requires_grad_(True)
    g = torch.Generator().manual_seed(0)
    s = tprob.sample(3, g)
    assert s.reparam and s.elbo_vi().requires_grad
    s.elbo_vi().backward()
    assert loc.grad is not None and loc.grad.abs() > 0
    loc.requires_grad_(False)
    assert float(s.elbo_rws()) == pytest.approx(float(s.elbo_vi().detach()), rel=1e-6)
    with pytest.raises(Exception, match="reparameterised"):
        tprob.sample(3, g, reparam=False).elbo_vi()


# ---- fit ------------------------------------------------------------------------------

def test_vi_converges_to_posterior():
    prob = conjugate()[1]
    d = _conjugate_data()
    post_prec = 1 / PRIOR_SCALE ** 2 + N / LIKE_SCALE ** 2
    post_mean = (PRIOR_MEAN / PRIOR_SCALE ** 2 + d.sum() / LIKE_SCALE ** 2) / post_prec
    elbos = train.fit(prob, method="vi", K=1, iters=1500, lr=0.05, device="cpu")
    q = prob.Q.opt_params()
    assert elbos.shape == (1500,)
    assert abs(float(q["a_loc"].data) - post_mean) < 0.2
    assert abs(float(q["a_scale"].data) - 1 / np.sqrt(post_prec)) < 0.2


def test_rws_converges_to_posterior():
    prob = conjugate()[1]
    d = _conjugate_data()
    post_prec = 1 / PRIOR_SCALE ** 2 + N / LIKE_SCALE ** 2
    post_mean = (PRIOR_MEAN / PRIOR_SCALE ** 2 + d.sum() / LIKE_SCALE ** 2) / post_prec
    train.fit(prob, method="rws", K=30, iters=400, lr=0.05, device="cpu")
    q = prob.Q.opt_params()
    assert abs(float(q["a_loc"].data) - post_mean) < 0.2
    assert abs(float(q["a_scale"].data) - 1 / np.sqrt(post_prec)) < 0.2
