"""The port's QEM step on MovieLens against ``alan_tpu``'s.

MovieLens with a QEM Q, grouped (mu_z and psi_z on one K-dim, the main
path's model) and ungrouped, at a small size (M=20 users, N=5 films,
d_z=18, K=30), data from a numpy seed, the same Q-draws injected into both packages (drawn
by ``alan_tpu``, carried across as numpy).  The port runs on the CPU with
the lazy low-rank path forced, so z's cross-K factor goes through
``LowRankDT.contract`` and the kernel module's plain version.

* Against ``alan_tpu``'s dense path: ELBO within 1e-5 relative, moments
  and the updated Q state at rtol/atol 1e-4.
* Against ``alan_tpu``'s lazy path, whose Pallas kernel (interpret mode)
  packs its scores as bf16x3: 1e-3, as ``tests/test_lowrank_lazy.py``.
"""
import jax
import numpy as np
import pytest
import torch

from alan_tpu.sample import Sample as JSample
from alan_tpu.sampler import PermutationSampler as JPerm
from alan_tpu.split import no_checkpoint as j_no_checkpoint
from alan_tpu_torch import convert, train
from alan_tpu_torch.models import movielens as tml
from alan_tpu_torch.ops import lowrank as tlr
from alan_tpu_torch.sample import Sample
from alan_tpu_torch.sampler import PermutationSampler
from test_torch_harness import (Env, JAX_DENSE, JAX_LAZY, PORT_LAZY,
                                assert_dt_close, assert_tree_close,
                                jax_movielens, port_movielens, port_np,
                                to_numpy_tree)

K, LR = 30, 0.3


@pytest.fixture(scope="module", params=["grouped", "ungrouped"])
def setup(request):
    arrays = tml.fake_data(seed=3, M=20, N=5)
    grouped = request.param == "grouped"
    jprob = jax_movielens(arrays, grouped)
    tprob = port_movielens(arrays, grouped)
    jtree, _ = jprob.Q._sample(K, False, JPerm, jprob.all_platedims,
                               jax.random.key(5))
    return jprob, tprob, jtree


def _jax_step(jprob, jtree, env):
    """alan_tpu's fused QEM step body on an injected sample."""
    with Env(**env):
        stP, stQ = jprob.P.state(), jprob.Q.state()
        gv2K = jprob.Q.plate.groupvarname2Kdim(K)
        s = JSample(jprob, jtree, gv2K, JPerm, False, states=(stP, stQ))
        rmP, rmQ = jprob.P.qem_flat_list_rmkeys, jprob.Q.qem_flat_list_rmkeys
        elbo, moms = s._moments_and_elbo(list(rmP) + list(rmQ), j_no_checkpoint)
        newQ = jprob.Q._updated_qem_state(LR, s, j_no_checkpoint, state=stQ,
                                          moments=moms[len(rmP):])
    return float(elbo), moms, newQ


def _port_step(tprob, jtree):
    tree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    calls = tlr.CONTRACT_CALLS
    with Env(**PORT_LAZY):
        step, state = train.qem(tprob, K, lr=LR, device="cpu")
        specs = tprob.P.qem_flat_list_rmkeys + tprob.Q.qem_flat_list_rmkeys
        s = Sample(tprob, tree, tprob.Q.plate.groupvarname2Kdim(K),
                   PermutationSampler, False, states=state)
        _, moms = s._moments_and_elbo(list(specs))
        (newP, newQ), elbo = step(state, sample=tree)
    lazy_calls = tlr.CONTRACT_CALLS - calls
    return float(elbo), moms, newQ, lazy_calls


@pytest.mark.parametrize("ref,rel,tol", [("dense", 1e-5, 1e-4), ("lazy", 1e-3, 1e-3)])
def test_qem_step_matches_jax(setup, ref, rel, tol):
    jprob, tprob, jtree = setup
    j_elbo, j_moms, j_newQ = _jax_step(jprob, jtree,
                                       JAX_DENSE if ref == "dense" else JAX_LAZY)
    t_elbo, t_moms, t_newQ, lazy_calls = _port_step(tprob, jtree)
    # the port's lazy contraction really ran: once for the moments pass
    # here and once inside the step
    assert lazy_calls == 2
    assert abs(t_elbo - j_elbo) <= rel * abs(j_elbo), (t_elbo, j_elbo)
    assert len(t_moms) == len(j_moms) == 6     # mu_z, psi_z, z: mean, mean2
    for jm, tm in zip(j_moms, t_moms):
        assert_dt_close(jm, tm, tol, tol)
    assert_tree_close(j_newQ["qem_params"], t_newQ["qem_params"], tol, tol)
    assert_tree_close(j_newQ["qem_means"], t_newQ["qem_means"], tol, tol)


def test_lazy_and_dense_port_paths_agree(setup):
    """The port's own dense path (materialised cross product) and its lazy
    path give the same step."""
    _, tprob, jtree = setup
    tree = convert.tree_from_numpy(to_numpy_tree(jtree), "cpu")
    out = {}
    for name, env in (("lazy", PORT_LAZY),
                      ("dense", dict(ALAN_TPU_LOWRANK_MIN=1,
                                     ALAN_TPU_NO_LAZY_LOWRANK=1))):
        with Env(**env):
            step, state = train.qem(tprob, K, lr=LR, device="cpu")
            out[name] = step(state, sample=tree)
    (_, qL), eL = out["lazy"]
    (_, qD), eD = out["dense"]
    assert abs(float(eL) - float(eD)) <= 1e-5 * abs(float(eD))
    for k in qD["qem_params"]:
        np.testing.assert_allclose(port_np(qL["qem_params"][k], qD["qem_params"][k].dims),
                                   port_np(qD["qem_params"][k]), rtol=1e-4, atol=1e-4)


def test_qem_runs_from_a_generator_with_schedule(setup):
    """Three steps drawing their own particles, under the delayed-averaging
    schedule: finite ELBOs, state shapes kept, the counter advances."""
    _, tprob, _ = setup
    with Env(**PORT_LAZY):
        step, state = train.qem(tprob, K, lr="0.5/t@1", device="cpu")
        g = torch.Generator().manual_seed(0)
        shapes = {k: tuple(v.data.shape) for k, v in state[0][1]["qem_params"].items()}
        for _ in range(3):
            state, elbo = step(state, g)
            assert np.isfinite(float(elbo))
    assert state[1] == 3.0
    assert {k: tuple(v.data.shape) for k, v in state[0][1]["qem_params"].items()} == shapes
    with pytest.raises(ValueError):
        step(state)


@pytest.mark.parametrize("lr", ["1/t", "0.1/t@200", "0.5/t@3"])
def test_schedules_match_jax(lr):
    """The schedule strings mean what alan_tpu/train.py:175-191 makes them."""
    import re
    sched = train._schedule(lr)
    if lr == "1/t":
        want = lambda t: 1.0 / (t + 1.0)
    else:
        lr0, T0 = (float(x) for x in re.fullmatch(r"([0-9.]+)/t@([0-9]+)", lr).groups())
        want = lambda t: lr0 if t < T0 else 1.0 / (t - T0 + 1.0 / lr0)
    for t in [0.0, 1.0, 2.0, 3.0, 10.0, 199.0, 200.0, 500.0]:
        assert sched(t) == pytest.approx(want(t))
    with pytest.raises(ValueError):
        train._schedule("fast")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    arrays = tml.fake_data(seed=0, M=4, N=2)
    ps, data, cov = tml.load_data_covariates(0, M=4, N=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tml.grouped_problem(ps, data, cov)
    prob = port_movielens(arrays)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.qem(prob, 3)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tml.grouped_problem(ps, data, cov, "opt")
    opt = tml.grouped_problem(ps, data, cov, "opt", device="cpu")
    for factory in (train.vi, train.rws):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            factory(opt, 3)
    for method in ("qem", "vi", "rws"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            train.fit(opt, method, K=3, iters=1)
