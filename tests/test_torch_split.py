"""The port's computation strategies (``alan_tpu_torch/split.py``,
``logpq.py``): ``Split`` and ``checkpoint`` against ``alan_tpu`` and
against ``no_checkpoint``, on the CPU.

* ``test_split_matches_jax``: ``elbo_vi``, ``elbo_rws`` (rtol 1e-5, atol
  1e-6) and the marginal weights (rtol 1e-4, atol 1e-5) under a ``Split``
  against ``alan_tpu``'s under the same ``Split`` (its side under
  ``jax.jit``), from the same particles: ``tests/model_model1.py``'s
  ``Split('p1', 3)`` (chunks of 3 and 1), ``Split('p1', 2)`` (two equal
  chunks), the linear Gaussian's ``Split('T', 4)`` (4, 4 and a remainder
  of 2; ``alan_tpu`` scans the equal chunks);
* ``test_strategy_is_exact``: each strategy against ``no_checkpoint`` in
  the port: the ELBOs (rtol 1e-5, atol 1e-6), the VI gradient of every
  opt param and the QEM moments (rtol 1e-4, atol 1e-5), the marginals
  (``allclose_dt``'s 1e-4 / 1e-5);
* covid at 4 regions x 16 days under ``Split("nRs", 2)`` and
  ``checkpoint`` against the unsplit ELBO, marginals and moments; under
  ``checkpoint`` each plate body runs twice a gradient; a ``Split`` of
  the days (a Timeseries plate) raises;
* the strategy defaults are ``alan_tpu``'s.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import model_linear_gaussian as jlg
import model_model1 as jm1
from alan_tpu import Split as JSplit
from alan_tpu import predict as jpredict
from alan_tpu import train as jtrain
from alan_tpu.sample import Sample as JSample
from alan_tpu.sampler import PermutationSampler as JPerm
from alan_tpu_torch import (BoundPlate, Data, Normal, PermutationSampler, Plate,
                            Problem, Split, checkpoint, convert, named,
                            no_checkpoint, predict, train)
from alan_tpu_torch import moments as tm
from alan_tpu_torch.dims import DT
from alan_tpu_torch.models import covid as tcovid
from alan_tpu_torch.sample import Sample
from alan_tpu_torch.train import opt_leaves
from alan_tpu_torch.utils import seeded_generator
from test_torch_harness import assert_dt_close, to_numpy_tree
from test_torch_zoo import model1

K = 3
ELBO_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)


def linear_gaussian():
    P = Plate(a=Normal(jlg.prior_mean, jlg.prior_scale),
              T=Plate(d=Normal(lambda a: jlg.mult * a, jlg.like_scale)))
    Q = Plate(a=Normal(1, 4), T=Plate(d=Data()))
    ps = {"T": jlg.N}
    data = {"d": named(torch.tensor(jlg.data_np, dtype=torch.float32), "T")}
    return Problem(BoundPlate(P, ps, device="cpu"), BoundPlate(Q, ps, device="cpu"),
                   data, device="cpu")


CASES = {
    "model1_p1_3": (lambda: model1().problem, jm1.tp.problem, "p1", 3,
                    [("a", tm.mean), ("d", tm.mean), ("c", tm.mean2)]),
    "model1_p1_2": (lambda: model1().problem, jm1.tp.problem, "p1", 2,
                    [("a", tm.mean), ("d", tm.mean)]),
    "linear_gaussian_T_4": (linear_gaussian, jlg.tp.problem, "T", 4,
                            [("a", tm.mean), ("a", tm.mean2)]),
}
_BUILT = {}


def case(name):
    """(port problem, alan_tpu problem, the port's tree, alan_tpu's tree,
    groupvarname2Kdim, plate, size, moments): K particles drawn by
    alan_tpu, carried to the port."""
    if name not in _BUILT:
        make, jprob, plate, size, moms = CASES[name]
        jtree = jax.jit(lambda key: jprob.Q._sample(K, False, JPerm, jprob.all_platedims,
                                                    key)[0])(jax.random.key(5))
        _BUILT[name] = (make(), jprob, convert.tree_from_numpy(to_numpy_tree(jtree), "cpu"),
                        jtree, jprob.Q.plate.groupvarname2Kdim(K), plate, size, moms)
    return _BUILT[name]


@pytest.mark.parametrize("name", list(CASES))
def test_split_matches_jax(name):
    tprob, jprob, ttree, jtree, gv2K, plate, size, _ = case(name)

    def jax_side(tree):
        cs = JSplit(plate, size)
        vi = JSample(jprob, tree, gv2K, JPerm, True).elbo_vi(computation_strategy=cs)
        s = JSample(jprob, tree, gv2K, JPerm, False)
        return vi, s.elbo_rws(computation_strategy=cs), s.marginals(
            computation_strategy=cs).weights
    jvi, jrws, jw = jax.jit(jax_side)(jtree)
    cs = Split(plate, size)
    tvi = Sample(tprob, ttree, gv2K, PermutationSampler, True).elbo_vi(cs)
    s = Sample(tprob, ttree, gv2K, PermutationSampler, False)
    np.testing.assert_allclose(float(tvi), float(jvi), **ELBO_TOL)
    np.testing.assert_allclose(float(s.elbo_rws(cs)), float(jrws), **ELBO_TOL)
    tw = s.marginals(computation_strategy=cs).weights
    assert set(tw) == set(jw)
    for k in jw:
        assert_dt_close(jw[k], tw[k], **TOL)


def _vi_grads(tprob, ttree, gv2K, cs):
    """(ELBO, gradients of every opt param and every particle) of a VI
    ELBO whose draws are ``ttree``."""
    leaves, sP, sQ = opt_leaves(tprob.P.state(), tprob.Q.state())
    tree = {}
    for k, v in ttree.items():
        tree[k] = (DT(v.data.clone().requires_grad_(True), v.dims)
                   if isinstance(v, DT) else v)
        if isinstance(v, DT):
            leaves.append(tree[k].data)
    s = Sample(tprob, tree, gv2K, PermutationSampler, True, states=(sP, sQ))
    elbo = s.elbo_vi(cs)
    return elbo.detach(), torch.autograd.grad(elbo, leaves, allow_unused=True)


@pytest.mark.parametrize("name,strategy", [(n, s) for n in CASES
                                           for s in ("checkpoint", "split")])
def test_strategy_is_exact(name, strategy):
    tprob, _, ttree, _, gv2K, plate, size, moms = case(name)
    cs = checkpoint if strategy == "checkpoint" else Split(plate, size)
    base_e, base_g = _vi_grads(tprob, ttree, gv2K, no_checkpoint)
    e, g = _vi_grads(tprob, ttree, gv2K, cs)
    np.testing.assert_allclose(float(e), float(base_e), **ELBO_TOL)
    assert len(g) == len(base_g) > 0
    for a, b in zip(g, base_g):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    s = Sample(tprob, ttree, gv2K, PermutationSampler, False)
    for f in ("elbo_rws", "elbo_nograd"):
        np.testing.assert_allclose(float(getattr(s, f)(cs)),
                                   float(getattr(s, f)(no_checkpoint)), **ELBO_TOL)
    base_e, base_m = s._moments_and_elbo(moms, no_checkpoint)
    e, m = s._moments_and_elbo(moms, cs)
    np.testing.assert_allclose(float(e), float(base_e), **ELBO_TOL)
    for a, b in zip(m, base_m):
        assert_dt_close(b, a, **TOL)
    base_w = s.marginals(computation_strategy=no_checkpoint).weights
    w = s.marginals(computation_strategy=cs).weights
    for k in base_w:
        assert_dt_close(base_w[k], w[k], **TOL)


# ---- covid ------------------------------------------------------------------

@pytest.fixture(scope="module")
def covid():
    ps, _, data, _, cov, _ = tcovid.load_data_covariates(4, nRs=4, nDs=20, device="cpu")
    data = {"obs": named(torch.poisson(torch.full((4, 16), 300.0),
                                       generator=seeded_generator(4, "cpu")),
                         "nRs", "nDs")}
    prob = tcovid.generate_problem(ps, data, cov, "qem", device="cpu")
    tree, gv2K = prob.Q._sample(K, False, PermutationSampler, prob.all_platedims,
                                seeded_generator(3, "cpu"))
    return prob, tree, gv2K


@pytest.mark.parametrize("strategy", ["split", "checkpoint"])
def test_covid_strategy_is_exact(covid, strategy):
    prob, tree, gv2K = covid
    cs = Split("nRs", 2) if strategy == "split" else checkpoint
    s = Sample(prob, tree, gv2K, PermutationSampler, False)
    moms = list(prob.Q.qem_flat_list_rmkeys)
    base_e, base_m = s._moments_and_elbo(moms, no_checkpoint)
    e, m = s._moments_and_elbo(moms, cs)
    np.testing.assert_allclose(float(e), float(base_e), **ELBO_TOL)
    for a, b in zip(m, base_m):
        assert_dt_close(b, a, **TOL)
    base_w = s.marginals(computation_strategy=no_checkpoint).weights
    w = s.marginals(computation_strategy=cs).weights
    for k in base_w:
        assert_dt_close(base_w[k], w[k], **TOL)


def test_checkpoint_runs_each_plate_body_once_more(covid, monkeypatch):
    """Under ``checkpoint`` the backward pass runs the forward once more:
    covid's three nested plate bodies (root, regions, days) run twice a
    gradient, not once more a level."""
    from alan_tpu_torch import logpq
    prob, tree, gv2K = covid
    body, calls = logpq._plate_body, []
    monkeypatch.setattr(logpq, "_plate_body",
                        lambda **kw: calls.append(kw["name"]) or body(**kw))
    s = Sample(prob, tree, gv2K, PermutationSampler, False)
    moms = list(prob.Q.qem_flat_list_rmkeys)
    counts = {}
    for cs in (no_checkpoint, checkpoint):
        calls.clear()
        s._moments_and_elbo(moms, cs)
        counts[type(cs).__name__] = sorted(calls, key=str)
    assert counts["NoCheckpoint"] == sorted([None, "nRs", "nDs"], key=str)
    assert counts["Checkpoint"] == sorted(2 * counts["NoCheckpoint"], key=str)


def test_split_across_a_timeseries_raises(covid):
    prob, tree, gv2K = covid
    s = Sample(prob, tree, gv2K, PermutationSampler, False)
    with pytest.raises(ValueError, match="Timeseries"):
        s.elbo_rws(Split("nDs", 8))


def test_split_size_must_be_below_the_plate():
    tprob, _, ttree, _, gv2K, _, _, _ = case("model1_p1_3")
    with pytest.raises(AssertionError, match="Split size"):
        Sample(tprob, ttree, gv2K, PermutationSampler, False).elbo_rws(Split("p1", 4))


# ---- the defaults -------------------------------------------------------------

def _default(f, arg="computation_strategy"):
    return type(inspect.signature(f).parameters[arg].default).__name__


@pytest.mark.parametrize("owner,jowner,f", [
    (Sample, JSample, "elbo_vi"), (Sample, JSample, "elbo_rws"),
    (Sample, JSample, "elbo_nograd"), (Sample, JSample, "marginals"),
    (Sample, JSample, "importance_sample"), (Sample, JSample, "_moments_and_elbo"),
    (train, jtrain, "vi"), (train, jtrain, "rws"), (train, jtrain, "qem"),
    (train, jtrain, "elbo_fn"), (predict, jpredict, "importance_sample_fn"),
    (predict, jpredict, "predictive_ll_fn")])
def test_strategy_defaults_are_alan_tpus(owner, jowner, f):
    assert _default(getattr(owner, f)) == _default(getattr(jowner, f))
