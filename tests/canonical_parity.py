"""One canonical example model in ``alan_tpu`` and in the port, on
``alan_tpu``'s data and particles, and the checks that
``tests/test_torch_canonical.py`` and ``tests/test_torch_canonical_reparam.py``
run on it.

``alan_tpu``'s fake data come from the JAX PRNG, which torch cannot
reproduce, so the port takes them (and ``alan_tpu``'s particles, at K = 3)
as numpy through ``alan_tpu_torch.convert``.  The JAX side runs under
``jax.jit``.  Where ``alan_tpu``'s chain log-matmul underflows (covid's
timeseries at Q's initial state) the port's joint-shift repair takes the
entries that it loses: there the port is held against itself with an
exact float64 chain, and with the repair off against ``alan_tpu``.
"""
import contextlib
import importlib

import jax
import numpy as np
import torch

import alan_tpu
from alan_tpu.sample import Sample as JSample
from alan_tpu.sampler import PermutationSampler as JPerm
from alan_tpu.split import no_checkpoint as j_no_checkpoint
from alan_tpu_torch import convert, predict, train
from alan_tpu_torch import mean as tmean
from alan_tpu_torch.sample import Sample
from alan_tpu_torch.sampler import PermutationSampler
from test_torch_harness import (Env, assert_dt_close, f64_chain_route, jax_recorded,
                                joint_count, joint_shift_off, to_numpy_tree)
from test_torch_training import (_jax_elbo_and_grads, _port_elbo_and_grads,
                                 jax_draws)

K, LR, N_DRAWS = 3, 0.1, 7


def port(tree):
    return convert.tree_from_numpy(to_numpy_tree(tree), "cpu")


@contextlib.contextmanager
def quick_compiles():
    """XLA's optimisations off while alan_tpu builds a problem: its
    BoundPlate draws from the prior op by op, and compiling each op takes
    most of a model's set-up."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


class Case:
    """``name`` with ``qtype`` in both packages from ``alan_tpu``'s loader
    (``load_kw`` its keyword arguments; ``data`` replaces its data, for
    covid's counts), and one particle tree of alan_tpu's."""

    def __init__(self, name, qtype, load_kw=None, env=None, data=None):
        self.name, self.qtype, self.env = name, qtype, env or {}
        jmod = importlib.import_module(name)
        self.tmod = importlib.import_module(f"alan_tpu_torch.models.{name}")
        with quick_compiles():
            # one compiled program: eager JAX compiles every op of the prior draw
            out = jax.jit(lambda key: jmod.load_data_covariates(
                key=key, **(load_kw or {}))[:6])(jax.random.key(0))
            ps, all_ps = ({k: int(v) for k, v in d.items()} for d in out[:2])
            jdata, all_jdata, jcov, all_jcov = out[2:]
            if data is not None:
                jdata, all_jdata = data(jdata, all_jdata)
            with Env(**self.env):
                self.jprob = jmod.generate_problem(ps, jdata, jcov, qtype)
        self.ps, self.all_ps = ps, all_ps
        self.jdata, self.jcov = jdata, jcov
        self.j_all = (all_jdata, all_jcov)
        self.t_all = (port(all_jdata), port(all_jcov))
        with Env(**self.env):
            self.tprob = self.tmod.generate_problem(ps, port(jdata), port(jcov), qtype,
                                                    device="cpu")
        with quick_compiles():
            self.jtree = jax.jit(lambda key: self.jprob.Q._sample(
                K, False, JPerm, self.jprob.all_platedims, key)[0])(jax.random.key(3))
        self.ttree = port(self.jtree)
        self.latents = sorted(self.jprob.Q.plate.varname2groupvarname())
        self.gv2K = self.jprob.Q.plate.groupvarname2Kdim(K)

    def jsample(self):
        return JSample(self.jprob, self.jtree, self.gv2K, JPerm, False,
                       states=(self.jprob.P.state(), self.jprob.Q.state()))

    def tsample(self):
        return Sample(self.tprob, self.ttree, self.tprob.Q.plate.groupvarname2Kdim(K),
                      PermutationSampler, False,
                      states=(self.tprob.P.state(), self.tprob.Q.state()))


_CASES = {}


def case(name, qtype, **kw):
    """The :class:`Case` of ``name`` and ``qtype``, built once a process."""
    if (name, qtype) not in _CASES:
        _CASES[name, qtype] = Case(name, qtype, **kw)
    return _CASES[name, qtype]


def _elbo_close(ref, got):
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref)), (float(got), float(ref))


def _against_reference(case, port_fn, jax_value, compare):
    """``port_fn()`` against ``jax_value``; where the port's joint shift
    took any entry, against ``port_fn()`` on an exact float64 chain, and
    ``port_fn()`` with the repair off against ``jax_value``.  Returns the
    number of repaired entries."""
    with Env(**case.env), joint_count() as joints:
        got = port_fn()
    if int(joints) == 0:
        compare(jax_value, got)
        return 0
    with Env(**case.env), f64_chain_route():
        compare(port_fn(), got)
    with Env(**case.env), joint_shift_off():
        compare(jax_value, port_fn())
    return int(joints)


def check_elbo_and_moments(case):
    """The ELBO at K = 3 (1e-5 relative) and the mean of every latent
    (rtol/atol 1e-4), from alan_tpu's particles at Q's initial state."""
    jm = [((v,), alan_tpu.mean) for v in case.latents]
    tm = [((v,), tmean) for v in case.latents]
    with Env(**case.env):
        j = jax.jit(lambda: case.jsample()._moments_and_elbo(jm, j_no_checkpoint))()

    def compare(ref, got):
        _elbo_close(ref[0], got[0])
        assert len(ref[1]) == len(got[1]) == len(case.latents)
        for r, g in zip(ref[1], got[1]):
            assert_dt_close(r, g, 1e-4, 1e-4)
    return _against_reference(case, lambda: case.tsample()._moments_and_elbo(tm), j, compare)


def check_qem_step(case):
    """One QEM step (lr 0.1) from alan_tpu's particles: its ELBO (1e-5
    relative) and the updated QEM state (rtol/atol 1e-4)."""
    jprob = case.jprob
    rmQ = list(jprob.Q.qem_flat_list_rmkeys)

    def jstep():
        stP, stQ = jprob.P.state(), jprob.Q.state()
        s = JSample(jprob, case.jtree, case.gv2K, JPerm, False, states=(stP, stQ))
        elbo, moms = s._moments_and_elbo(rmQ, j_no_checkpoint)
        return elbo, jprob.Q._updated_qem_state(LR, s, j_no_checkpoint, state=stQ,
                                                moments=moms)
    with Env(**case.env):
        j = jax.jit(jstep)()

    def tstep():
        step, state = train.qem(case.tprob, K, lr=LR, device="cpu")
        (_, newQ), elbo = step(state, sample=case.ttree)
        return elbo, newQ

    def compare(ref, got):
        _elbo_close(ref[0], got[0])
        for group in ("qem_params", "qem_means"):
            assert set(ref[1][group]) == set(got[1][group])
            for k in ref[1][group]:
                assert_dt_close(ref[1][group][k], got[1][group][k], 1e-4, 1e-4)
    return _against_reference(case, tstep, j, compare)


def check_gradients(case, method):
    """The VI or RWS ELBO (1e-5 relative) and its gradient with respect to
    every opt param (rtol/atol 1e-4), from alan_tpu's draws."""
    reparam = method == "vi"
    key = jax.random.key(7)
    with Env(**case.env):
        j = _jax_elbo_and_grads(case.jprob, K, reparam, key)
        draws = jax_draws(case.jprob, K, reparam, key, case.jprob.Q.state())

    def compare(ref, got):
        _elbo_close(ref[0], got[0])
        for side in ("P", "Q"):
            assert set(ref[1][side]) == set(got[1][side])
            for k in ref[1][side]:
                assert_dt_close(ref[1][side][k], got[1][side][k], 1e-4, 1e-4)
    return _against_reference(
        case, lambda: _port_elbo_and_grads(case.tprob, K, reparam, draws), j, compare)


def check_predictive_ll(case):
    """``predict.predictive_ll_fn`` over the extended plates at N = 7,
    given alan_tpu's particles and replay noise, against alan_tpu's
    pipeline (importance sample, extend, predictive_ll): 1e-5 relative."""
    js = case.jsample()
    all_jdata, all_jcov = case.j_all

    def pipeline(k_is, k_ext):
        jis = js.importance_sample(N_DRAWS, j_no_checkpoint, key=k_is)
        jext = jis.extend(case.all_ps, all_jcov, key=k_ext)
        return {k: v.data for k, v in jext.predictive_ll(all_jdata).items()}
    with Env(**case.env):
        jpll, jd = jax_recorded(pipeline, jax.random.key(11), jax.random.key(2))
    f = predict.predictive_ll_fn(case.tprob, K, N_DRAWS, case.all_ps)
    all_tdata, all_tcov = case.t_all
    with Env(**case.env):
        tpll = f(case.tprob.P.state(), case.tprob.Q.state(), all_tcov, all_tdata,
                 torch.Generator().manual_seed(0), sample=case.ttree,
                 noise=[g for g, _, _ in jd])
    assert set(tpll) == set(jpll)
    for k in jpll:
        assert np.isfinite(float(tpll[k]))
        np.testing.assert_allclose(float(tpll[k]), float(jpll[k]), rtol=1e-5)


def check_own_data(case, **kw):
    """The port's own loader at the published sizes: the sizes and data
    dims of alan_tpu's loader, and a finite ELBO at K = 3 on the CPU."""
    problem, all_data, all_cov, all_ps = case.tmod.load_and_generate_problem(
        Q_param_type=case.qtype, device="cpu", **kw)
    assert all_ps == case.all_ps
    assert {k: problem.all_platedims[k] for k in case.ps} == case.ps
    for k, v in case.jdata.items():
        assert set(all_data[k].dims) == set(v.dims)
    assert set(all_cov) == set(case.jcov)
    s = problem.sample(K, torch.Generator().manual_seed(0), reparam=False)
    assert np.isfinite(float(s.elbo_nograd()))


def check_real_data_loader(name, arrays, tmp_path, **kw):
    """``fake_data=False`` on ``.npy`` files written here: the port's
    loader gives the sizes, data and covariates of alan_tpu's."""
    for stem, a in arrays.items():
        np.save(tmp_path / f"{stem}.npy", a)
    jmod = importlib.import_module(name)
    tmod = importlib.import_module(f"alan_tpu_torch.models.{name}")
    j = jmod.load_data_covariates(fake_data=False, data_dir=str(tmp_path), **kw)
    t = tmod.load_data_covariates(fake_data=False, data_dir=str(tmp_path), device="cpu",
                                  **kw)
    assert t[0] == j[0] and t[1] == j[1]
    for jd, td in zip(j[2:6], t[2:6]):
        assert set(jd) == set(td)
        for k in jd:
            assert_dt_close(jd[k], td[k], 0, 0)
    return t
