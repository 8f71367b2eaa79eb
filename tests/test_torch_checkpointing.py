"""The port's checkpoint and resume (``alan_tpu_torch/checkpointing.py``),
on the CPU.

* ``tests/test_infra.py``'s two oracles (:14-34, :134-151) on the port:
  a QEM problem saved with extras, loaded into a fresh problem, and
  resumed identically; a scheduled QEM state ``((stateP, stateQ), t)``
  round-tripped and stepped bit-exactly;
* a round trip of every kind of leaf: DT, tensor (0-d float32 too), Python
  scalars, None, a tuple, a list, ``torch.optim.Adam``'s state dict (its
  integer keys), a generator's state;
* resuming is bitwise: N steps equal N/2, a save, a load into a fresh
  problem and N/2 more (QEM with its schedule, VI with Adam's state and the
  generator);
* across packages: ``alan_tpu``'s ``save_problem`` file loads into the
  port and equals ``convert``'s state of it; the port's file loads with
  ``alan_tpu``'s ``load_checkpoint`` and equals the port's state.
"""
import jax
import numpy as np
import pytest
import torch

import model_model1 as jm1
from alan_tpu import checkpointing as jck
from alan_tpu import train as jtrain
from alan_tpu_torch import convert, train
from alan_tpu_torch.checkpointing import (load_checkpoint, load_problem, save_checkpoint,
                                          save_problem)
from alan_tpu_torch.dims import DT
from alan_tpu_torch.utils import seeded_generator
from test_torch_harness import to_numpy_tree
from test_torch_zoo import model1


def _leaves_equal(a, b):
    """Two trees are equal leaf by leaf, bitwise, with the same structure,
    key types and dims."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
    elif isinstance(a, DT):
        assert a.dims == b.dims
        _leaves_equal(a.data, b.data)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and a.shape == b.shape
        assert torch.equal(a, b)
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state())
    else:
        assert a == b


def test_checkpoint_resume(tmp_path):
    prob = model1().problem
    train.fit(prob, method="qem", K=5, iters=3, device="cpu")
    p = str(tmp_path / "ck")
    save_problem(p, prob, extra={"step": 3})

    prob2 = model1().problem
    assert load_problem(p, prob2) == {"step": 3}
    for k, v in prob.Q.state()["qem_means"].items():
        w = prob2.Q.state()["qem_means"][k]
        assert v.dims == w.dims and torch.equal(v.data, w.data)
    e1 = train.fit(prob, method="qem", K=5, iters=2, generator=seeded_generator(9, "cpu"),
                   device="cpu")
    e2 = train.fit(prob2, method="qem", K=5, iters=2, generator=seeded_generator(9, "cpu"),
                   device="cpu")
    assert torch.equal(e1, e2)


def test_checkpoint_scheduled_qem_state(tmp_path):
    step, state = train.qem(model1().problem, 5, lr="0.1/t@2", device="cpu")
    gen = seeded_generator(4, "cpu")
    for _ in range(3):
        state, _ = step(state, gen)
    p = str(tmp_path / "sched_ck")
    save_checkpoint(p, state)
    state2 = load_checkpoint(p)
    assert state2[1].dtype == torch.float32 and state2[1].dim() == 0
    assert float(state2[1]) == float(state[1]) == 3.0
    _leaves_equal(state, state2)
    s_a, _ = step(state, seeded_generator(5, "cpu"))
    s_b, _ = step(state2, seeded_generator(5, "cpu"))
    _leaves_equal(s_a, s_b)


def test_every_kind_of_leaf_round_trips(tmp_path):
    step, state = train.vi(model1().problem, 3, device="cpu")
    gen = seeded_generator(1, "cpu")
    state, _ = step(state, gen)
    opt_state = state[2]
    assert all(isinstance(k, int) for k in opt_state["state"])
    tree = {"dt": DT(torch.arange(6.0).reshape(2, 3), ("p",)),
            "tensor": torch.arange(4, dtype=torch.int64), "t": torch.tensor(3.0),
            "mask": torch.tensor([True, False]),
            "scalars": (1, 2.5, True, "name", 0.1 + 0.2), "none": None,
            "list": [1, [2.0, None]], "adam": opt_state, "generator": gen,
            "state": state}
    p = str(tmp_path / "leaves")
    save_checkpoint(p, tree)
    _leaves_equal(tree, load_checkpoint(p))
    # the generator resumes the draws where it was saved
    g2 = load_checkpoint(p)["generator"]
    assert torch.equal(torch.randn(5, generator=gen), torch.randn(5, generator=g2))


@pytest.mark.parametrize("method", ["qem", "vi"])
def test_resume_is_bitwise(tmp_path, method):
    """Four steps, against two, a save (state and generator), a load into a
    fresh problem's step and two more."""
    kw = {"lr": "0.1/t@2"} if method == "qem" else {}
    step, state0 = getattr(train, method)(model1().problem, 5, device="cpu", **kw)
    full, _ = train._eager(step, 4, state0, seeded_generator(7, "cpu"))

    gen = seeded_generator(7, "cpu")
    half, _ = train._eager(step, 2, state0, gen)
    p = str(tmp_path / "resume")
    save_checkpoint(p, {"state": half, "generator": gen})
    ck = load_checkpoint(p)
    step2, _ = getattr(train, method)(model1().problem, 5, device="cpu", **kw)
    resumed, _ = train._eager(step2, 2, ck["state"], ck["generator"])
    _leaves_equal(full, resumed)


def test_alan_tpu_checkpoint_loads_into_the_port(tmp_path):
    jprob = jm1.tp.problem
    saved = (jprob.P.state(), jprob.Q.state())
    try:
        jtrain.fit(jprob, method="qem", K=5, iters=2, key=jax.random.key(2))
        p = str(tmp_path / "from_jax")
        jck.save_problem(p, jprob, extra={"step": 2})
        tprob = model1().problem
        assert load_problem(p, tprob) == {"step": 2}
        for part, jpart in ((tprob.P, jprob.P), (tprob.Q, jprob.Q)):
            _leaves_equal(convert.state_from_numpy(to_numpy_tree(jpart.state()), "cpu"),
                          part.state())
    finally:
        jprob.P.set_state(saved[0])
        jprob.Q.set_state(saved[1])


def test_port_checkpoint_loads_into_alan_tpu(tmp_path):
    tprob = model1().problem
    train.fit(tprob, method="qem", K=5, iters=2, device="cpu")
    p = str(tmp_path / "from_port")
    save_problem(p, tprob, extra={"step": 2})
    ck = jck.load_checkpoint(p)
    assert ck["extra"] == {"step": 2}
    for part, name in ((tprob.P, "P"), (tprob.Q, "Q")):
        for group, vals in part.state().items():
            assert set(ck[name][group]) == set(vals)
            for k, v in vals.items():
                assert tuple(ck[name][group][k].dims) == v.dims
                np.testing.assert_array_equal(np.asarray(ck[name][group][k].data),
                                              v.data.numpy())
