"""The port's captured training loop on the CPU: ``train.scan_steps``,
``train.vmap_runs``, ``fit(fuse_iters=True)``, the QEM schedule on a device
tensor and Adam's state built up front.

On the CPU ``scan_steps`` is the eager loop (the plain version of the
captured graph), so these tests hold it and ``vmap_runs`` to the eager
steps draw for draw.  With the per-step parity tests
(``tests/test_torch_training.py``, ``tests/test_torch_movielens_qem.py``:
a port step equals ``alan_tpu``'s on the same draws) and ``alan_tpu``'s own
(``tests/test_training.py``: its scan equals its eager loop) they hold the
scanned trajectory to ``alan_tpu``'s.  The graph itself runs on the card:
``tests/test_torch_kernels_cuda.py`` holds a graphed loop to its eager
loop there.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alan_tpu import train as jtrain
from alan_tpu_torch import (BoundPlate, Data, Normal, OptParam, Plate, Problem,
                            QEMParam, named, train)
from alan_tpu_torch.dims import DT
from test_torch_harness import assert_tree_close
from test_torch_training import conjugate, jax_draws

N = 6


def _problem(qtype):
    """A two-level model (a global latent, a latent per datum) with a QEM
    or an opt Q, so that Q permutes a parent's particles."""
    d = (1.5 + np.random.default_rng(5).standard_normal(N)).astype(np.float32)
    P = Plate(a=Normal(2.0, 2.0), T=Plate(z=Normal("a", 1.3), d=Normal("z", 1.5)))
    if qtype == "qem":
        Q = Plate(a=Normal(QEMParam(1.0), QEMParam(4.0)),
                  T=Plate(z=Normal(QEMParam(0.0), QEMParam(3.0)), d=Data()))
    else:
        Q = Plate(a=Normal(OptParam(1.0), OptParam(math.log(4.0), transformation=torch.exp)),
                  T=Plate(z=Normal(OptParam(0.0), OptParam(1.0, transformation=torch.exp)),
                          d=Data()))
    sizes = {"T": N}
    return Problem(BoundPlate(P, sizes, device="cpu"), BoundPlate(Q, sizes, device="cpu"),
                   {"d": named(torch.tensor(d), "T")}, device="cpu")


#: (name, factory, Q type, lr)
STEPS = {
    "qem": (train.qem, "qem", 0.2),
    "qem_1/t": (train.qem, "qem", "1/t"),
    "qem_0.5/t@3": (train.qem, "qem", "0.5/t@3"),
    "vi": (train.vi, "opt", 0.05),
    "rws": (train.rws, "opt", 0.05),
    "global_vi": (train.global_vi, "opt", 0.05),
    "global_rws": (train.global_rws, "opt", 0.05),
    "global_qem": (train.global_qem, "qem", 0.2),
}


def _step(name, K=4):
    factory, qtype, lr = STEPS[name]
    return factory(_problem(qtype), K, lr=lr, device="cpu")


def _leaves_equal(a, b):
    la, sa = train._flatten(a)
    lb, sb = train._flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _eager(step, state, gen, n):
    elbos = []
    for _ in range(n):
        state, elbo = step(state, gen)
        elbos.append(elbo)
    return state, torch.stack(elbos)


@pytest.mark.parametrize("name", list(STEPS))
def test_scan_steps_matches_eager_loop(name):
    """``scan_steps(step, n)`` from a generator equals the eager loop from a
    generator of the same seed: every ELBO and the final state, and the
    generator advanced alike (the port's counterpart of
    ``tests/test_training.py:274-286``)."""
    step, state0 = _step(name)
    g_eager, g_scan = (torch.Generator().manual_seed(3) for _ in range(2))
    st_e, el_e = _eager(step, state0, g_eager, 5)
    st_s, el_s = train.scan_steps(step, 5)(state0, g_scan)
    assert el_s.shape == (5,) and torch.isfinite(el_s).all()
    torch.testing.assert_close(el_s, el_e, rtol=0, atol=0)
    _leaves_equal(st_s, st_e)
    assert torch.equal(g_eager.get_state(), g_scan.get_state())
    assert len(set(el_s.tolist())) > 1


def test_vmap_runs_rows_match_scan_steps():
    """Each row of ``vmap_runs`` equals ``scan_steps`` from its run's
    generator, distinct runs differ, and every leaf carries the runs axis
    (``tests/test_training.py:289-303``)."""
    step, state0 = _step("qem")
    states, elbos = train.vmap_runs(step, n_steps=4, n_runs=3)(state0, 11)
    assert elbos.shape == (3, 4)
    run = train.scan_steps(step, 4)
    for r in range(3):
        st, e = run(state0, train.run_generator(11, r, "cpu"))
        torch.testing.assert_close(elbos[r], e, rtol=0, atol=0)
        _leaves_equal(train.run_state(states, r), st)
    assert not torch.allclose(elbos[0], elbos[1])
    z_loc = states[1]["qem_params"]["z_loc"]
    assert z_loc.dims[0] == "runs" and z_loc.dim_size("runs") == 3
    # run seeds are a fixed function of the caller's seed and the run
    assert train.run_generator(11, 2, "cpu").initial_seed() == \
        train.run_generator(11, 2, "cpu").initial_seed()
    assert len({train.run_generator(s, r, "cpu").initial_seed()
                for s in (0, 1) for r in range(3)}) == 6


@pytest.mark.parametrize("method", ["qem", "vi", "rws", "global_vi", "global_rws",
                                    "global_qem"])
def test_fit_fuse_iters_equals_fit(method):
    qtype = "qem" if method.endswith("qem") else "opt"
    out = []
    for fuse in (False, True):
        prob = _problem(qtype)
        e = train.fit(prob, method, K=3, iters=4, generator=torch.Generator().manual_seed(2),
                      fuse_iters=fuse, device="cpu")
        out.append((e, prob.P.state(), prob.Q.state()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    _leaves_equal(out[1][1:], out[0][1:])
    assert out[0][0].shape == (4,)


def _jax_schedule(lr):
    """``alan_tpu``'s own schedule function, out of its jitted QEM step."""
    step, _ = jtrain.qem(conjugate_qem_problem(), 2, lr=lr)
    return inspect.getclosurevars(step.__wrapped__).nonlocals["schedule"]


def conjugate_qem_problem():
    from alan_tpu import (BoundPlate as JB, Data as JD, Normal as JN, Plate as JP,
                          Problem as JPr, QEMParam as JQ, named as jn)
    P = JP(a=JN(0.0, 1.0), T=JP(d=JN("a", 1.0)))
    Q = JP(a=JN(JQ(0.0), JQ(1.0)), T=JP(d=JD()))
    return JPr(JB(P, {"T": 2}), JB(Q, {"T": 2}), {"d": jn(jnp.zeros(2), "T")})


@pytest.mark.parametrize("lr", ["1/t", "0.5/t@3", "0.1/t@200"])
def test_schedule_on_device_tensor_matches_jax(lr):
    """The schedule evaluated on a 0-d float32 tensor gives ``alan_tpu``'s
    ``lr_t`` for t = 0..10 (and at the switch), and the QEM state carries
    ``t`` as such a tensor."""
    jsched, tsched = _jax_schedule(lr), train._schedule(lr)
    ts = list(range(11)) + [199, 200, 201]
    want = np.array([float(jsched(jnp.float32(t))) for t in ts], np.float32)
    got = np.array([float(tsched(torch.tensor(float(t)))) for t in ts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    step, state0 = train.qem(_problem("qem"), 3, lr=lr, device="cpu")
    t0 = state0[1]
    assert isinstance(t0, torch.Tensor) and t0.dtype == torch.float32 and t0.dim() == 0
    (_, t1), _ = step(state0, torch.Generator().manual_seed(0))
    assert isinstance(t1, torch.Tensor) and float(t1) == 1.0


@pytest.mark.parametrize("name", list(STEPS))
def test_step_keeps_the_state_structure(name):
    """Every step's state has the structure and shapes of the state it was
    given, from step 0 on: a graph captures one step and carries its state
    from replay to replay."""
    step, state0 = _step(name)
    gen = torch.Generator().manual_seed(1)
    state1, _ = step(state0, gen)
    state2, _ = step(state1, gen)
    for st in (state1, state2):
        l0, s0 = train._flatten(state0)
        l1, s1 = train._flatten(st)
        assert s1 == s0
        assert [x.shape for x in l1] == [x.shape for x in l0]


def test_adam_state_up_front_matches_optax():
    """With Adam's state built up front (step 0, zero moments, as Adam
    builds it at its first step) the first VI step still matches
    ``optax.adam``'s, rtol/atol 1e-4, and the state's step count is 1."""
    jprob, tprob = conjugate()
    lr, K = 0.05, 3
    jstep, jstate = jtrain.vi(jprob, K, lr=lr)
    tstep, tstate = train.vi(tprob, K, lr=lr, device="cpu")
    for st in tstate[2]["state"].values():
        assert float(st["step"]) == 0.0
        assert all(float(st[k].abs().max()) == 0.0 for k in ("exp_avg", "exp_avg_sq"))
    key = jax.random.key(30)
    draws = jax_draws(jprob, K, True, key, jstate[1])
    jstate, j_elbo = jstep(jstate, key)
    tstate, t_elbo = tstep(tstate, **draws)
    assert abs(float(t_elbo) - float(j_elbo)) <= 1e-5 * abs(float(j_elbo))
    for side in (0, 1):
        assert_tree_close(jstate[side]["opt"], tstate[side]["opt"], 1e-4, 1e-4)
    assert all(float(st["step"]) == 1.0 for st in tstate[2]["state"].values())


def test_flatten_round_trip():
    state = ({"opt": {"a": DT(torch.arange(6.0).reshape(2, 3), ("T",))}},
             [torch.tensor(1.0), 0.5, None, ("x", 2)])
    leaves, spec = train._flatten(state)
    assert len(leaves) == 2
    back = train._unflatten(spec, leaves)
    assert back[0]["opt"]["a"].dims == ("T",) and back[1][1:] == [0.5, None, ("x", 2)]
    runs = train._unflatten(spec, [torch.stack([x, x]) for x in leaves],
                            lambda ds: ("runs", *ds))
    assert runs[0]["opt"]["a"].dims == ("runs", "T")
    one = train.run_state(runs, 1)
    assert one[0]["opt"]["a"].dims == ("T",)
    torch.testing.assert_close(one[0]["opt"]["a"].data, leaves[0])


def test_scan_steps_rejects_bad_lengths():
    step, _ = _step("qem")
    with pytest.raises(ValueError):
        train.scan_steps(step, 0)
    with pytest.raises(ValueError):
        train.vmap_runs(step, 3, 0)
