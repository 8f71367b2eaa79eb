"""The port's mesh plans (``alan_tpu_torch/parallel/``) against
``alan_tpu``'s unsharded steps, on the CPU.

One group of 4 gloo ranks on 127.0.0.1, started once for the file: the
file itself is the worker (``python tests/test_torch_parallel.py --rank R
--world 4 --port P --dir D``).  The test process draws ``alan_tpu``'s
particles (a QEM step's particle tree, a VI step's standard noise), runs
``alan_tpu``'s unsharded steps on them under ``jax.jit``, and hands the
particles to the workers, which run the port's planned steps on them;
``alan_tpu``'s own tests show its sharded step equals its unsharded one,
so its 8-device programs are not compiled here.  The cases
(``tests/test_sharding.py``'s, with its tolerances):

* the tiny problem under ``{"plate_1": "p"}`` + all K on ``{k: 2, p: 2}``:
  QEM and VI, ELBO and state within 1e-4 (1e-3 / 1e-4 for VI's Adam step),
  and with the matmul contraction forced (``:44-116``);
* the covid-shaped problem under ``{"T": "t"}`` on ``{t: 4}``: QEM state
  within 1e-3 / 1e-4 and a VI step's parameters, the T-sharded chain
  taken (``:213-260``);
* ``seq``'s all-gather, ring and butterfly against ``alan_tpu``'s
  ``chain_logmmexp`` within 1e-4, the butterfly bitwise the port's
  single-rank chain, value and gradient (``:80-93``, ``:264-294``);
* ``Split("plate_1", 8)`` under ``{"plate_2": "p"}`` + all K
  (``:347-370``);
* the collective inventory: all-reduces in the planned step and no
  collective in the plain one, an all-gather or a permute in the
  T-sharded step, ``scaling_report``'s efficiencies in (0, 1] and
  falling with more cards, and the MovieLens headline at K=30 on
  ``{k: 2, p: 2}`` with under 1,000,000 all-gathered bytes (``:298-408``);
* the undividable dim's warning (once) and the strict error on a mesh
  axis of 4 (``:119-150``), which needs the group's 4 ranks;
* ``distributed.initialize()``: False with no address, and the workers'
  group started by it;
* ``scan_steps`` and ``vmap_runs`` of a planned step, bitwise its eager
  loop (on the CPU they are that loop, run under the plan).

In the test process, one rank: a world-size-1 plan gives the unsharded
step's ELBO and state bitwise.  Every planned step runs under
``StrictViews``: a view that merges a sharded dim anywhere but majormost
raises, as some torch versions' DTensor does (the card's did).
"""
import argparse
import contextlib
import math
import os
import pickle
import socket
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from alan_tpu_torch import (BoundPlate, Data, Normal, OptParam, Plate, Problem,
                            QEMParam, Split, Timeseries, named, train)
from alan_tpu_torch.dims import DT
from alan_tpu_torch.parallel import collective_audit, distributed, seq
from alan_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from alan_tpu_torch.utils import seeded_generator

WORLD = 4
K_TINY, K_COVID, K_COVID_VI = 8, 8, 4


# ---- the problems, in the port ------------------------------------------------

def tiny(param=QEMParam):
    """``tests/test_sharding.py``'s ``_tiny_problem`` (``param`` its Q's
    parameter kind)."""
    P = Plate(mu=Normal(0., 1.),
              plate_1=Plate(z=Normal("mu", 1.), plate_2=Plate(obs=Normal("z", 1.))))
    Q = Plate(mu=Normal(param(0.), param(1.)),
              plate_1=Plate(z=Normal(param(0.), param(1.)), plate_2=Plate(obs=Data())))
    ps = {"plate_1": 16, "plate_2": 4}
    rng = np.random.default_rng(0)
    data = {"obs": named(torch.tensor(rng.standard_normal((16, 4)), dtype=torch.float32),
                         "plate_1", "plate_2")}
    return Problem(BoundPlate(P, ps, device="cpu"), BoundPlate(Q, ps, device="cpu"),
                   data, device="cpu")


def covid_shaped(R=4, T=16, param="qem"):
    """``tests/test_sharding.py``'s ``_covid_shaped_problem``."""
    Par = QEMParam if param == "qem" else OptParam
    P = Plate(mu=Normal(0., 1.), regions=Plate(init=Normal("mu", 1.), T=Plate(
        ts=Timeseries("init", Normal(lambda prev: 0.9 * prev, 0.3)),
        obs=Normal("ts", 1.))))
    Q = Plate(mu=Normal(Par(0.), Par(1.)),
              regions=Plate(init=Normal(Par(0.), Par(1.)),
                            T=Plate(ts=Normal(Par(0.), Par(1.)), obs=Data())))
    ps = {"regions": R, "T": T}
    rng = np.random.default_rng(3)
    data = {"obs": named(torch.tensor(rng.standard_normal((R, T)), dtype=torch.float32),
                         "regions", "T")}
    return Problem(BoundPlate(P, ps, device="cpu"), BoundPlate(Q, ps, device="cpu"),
                   data, device="cpu")


#: the factored log-densities' lazy route forced, as at full size
LAZY = {"ALAN_TPU_LOWRANK_MIN": "1", "ALAN_TPU_LAZY_LOWRANK": "1"}


def real_models():
    """``chip_smoke.py``'s planned paths at small sizes: name -> (make(plan)
    -> (step, state0), plan kind).  Grouped MovieLens (QEM, VI) and covid
    with their factored factors on the lazy route, AR(1)'s ELBO."""
    from alan_tpu_torch.models import ar1, covid
    from alan_tpu_torch.models import movielens as ml
    ps, data, cov = ml.load_data_covariates(seed=0, M=12, N=3, device="cpu")
    cps, _, cdata, _, ccov, _ = covid.load_data_covariates(seed=0, nRs=4, nDs=10,
                                                          device="cpu")
    cprob = covid.generate_problem(cps, cdata, ccov, "qem", device="cpu")
    ar = ar1.generate_problem("cpu")

    def ar1_step(plan):
        f = train.elbo_fn(ar, 64, reparam=False, mesh_plan=plan)
        return (lambda st, g: (st, f(st[0], st[1], g).detach())), (ar.P.state(), ar.Q.state())
    return {
        "grouped_qem": (lambda plan: train.qem(ml.grouped_problem(ps, data, cov, device="cpu"),
                                               6, lr=0.1, device="cpu", mesh_plan=plan),
                        "plate_1"),
        "grouped_vi": (lambda plan: train.vi(ml.grouped_problem(ps, data, cov, "opt",
                                                                device="cpu"),
                                             6, lr=0.01, device="cpu", mesh_plan=plan),
                       "plate_1"),
        "covid_nRs": (lambda plan: train.qem(cprob, 4, lr=0.1, device="cpu", mesh_plan=plan),
                      "nRs"),
        "covid_nDs": (lambda plan: train.qem(cprob, 4, lr=0.1, device="cpu", mesh_plan=plan),
                      "nDs"),
        "ar1": (ar1_step, "T"),
    }


def planned_vs_unsharded(make, plan, seed=3):
    """One step of ``make(None)`` and of ``make(plan)`` from one generator
    seed and state: (ELBOs, state leaves) of each."""
    out = []
    for p in (None, plan):
        step, state0 = make(p)
        with strict_views(p):
            state, elbo = step(state0, seeded_generator(seed, "cpu"))
        out.append((elbo, train._flatten(state)[0]))
    return out


class StrictViews(TorchDispatchMode):
    """Raise on a view of a ``DTensor`` that merges a sharded dim anywhere
    but majormost in its output dim.  Some torch versions' DTensor takes
    such a view (as a strided shard); others refuse it, as the card's
    did, so the planned steps here are held to the stricter rule."""

    VIEWS = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if StrictViews.VIEWS is None:
            aten = torch.ops.aten
            StrictViews.VIEWS = {aten.view.default, aten._unsafe_view.default,
                                 aten.reshape.default}
        if func in StrictViews.VIEWS and isinstance(args[0], DTensor):
            t, shape = args[0], list(args[1])
            src = tuple(t.shape)
            if -1 in shape:
                i = shape.index(-1)
                shape[i] = math.prod(src) // math.prod(d for d in shape if d != -1)
            starts = {math.prod(shape[:j]) for j in range(len(shape) + 1)}
            for p in t.placements:
                if p.is_shard() and src[p.dim] > 1 and math.prod(src[:p.dim]) not in starts:
                    raise RuntimeError(f"a view merges a sharded dim: {src} "
                                       f"{t.placements} -> {shape}")
        if any(issubclass(ty, DTensor) for ty in types):
            return NotImplemented
        return func(*args, **(kwargs or {}))


def strict_views(plan):
    return StrictViews() if plan is not None else contextlib.nullcontext()


def chain_operands():
    rng0, rng6 = np.random.default_rng(0), np.random.default_rng(6)
    return {"plain": rng0.standard_normal((2, 32, 8, 8)).astype(np.float32),
            "spread": (rng6.standard_normal((3, 32, 8, 8)) * 4 - 2).astype(np.float32)}


# ---- numpy trees between the processes ------------------------------------------

def to_port(tree):
    """A tree of ``("DT", array, dims)`` as port DTs on the CPU."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if tree is None:
        return None
    _, a, dims = tree
    return DT(torch.from_numpy(np.array(a)), dims)


def from_port(tree):
    if isinstance(tree, dict):
        return {k: from_port(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_port(v) for v in tree)
    if isinstance(tree, DT):
        return ("DT", tree.data.detach().numpy().copy(), tree.dims)
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return tree


# ---- the worker -------------------------------------------------------------------

def _qem(problem, K, plan, sample=None, strategy=None, gen_seed=None):
    kw = {} if strategy is None else {"computation_strategy": strategy}
    step, state = train.qem(problem, K, lr=0.1, device="cpu", mesh_plan=plan, **kw)
    with strict_views(plan):
        if sample is not None:
            return step(state, sample=to_port(sample))
        return step(state, seeded_generator(gen_seed, "cpu"))


def _vi(problem, K, plan, noise):
    step, state = train.vi(problem, K, lr=0.01, device="cpu", mesh_plan=plan)
    with strict_views(plan):
        return step(state, noise=to_port(noise))


def _state(state, kind):
    return {k: v.data.numpy().copy() for k, v in state[1][kind].items()}


def _wait_for_inputs(out_dir, timeout=300):
    """The particles the test process draws while the workers start (it
    writes them whole, by a rename)."""
    path = os.path.join(out_dir, "inputs.pkl")
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def worker(rank, world, port, out_dir):
    assert not distributed.initialize(), "no address is configured: a no-op"
    started = distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                                     device_type="cpu")
    torch.manual_seed(0)
    kp = make_mesh({"k": 2, "p": 2}, device_type="cpu")
    t4 = make_mesh({"t": 4}, device_type="cpu")
    k4 = make_mesh({"k": 4}, device_type="cpu")
    plan_kp = MeshPlan(kp, {"plate_1": "p"}).with_all_K("k")
    plan_t = MeshPlan(t4, {"T": "t"})
    res = {"initialized": started}

    # the card's planned paths at small sizes, against the unsharded port
    res["real"] = {}
    os.environ.update(LAZY)
    try:
        for name, (make, kind) in real_models().items():
            if kind == "nDs":
                continue        # 8 training days do not divide 4 ranks; the T case is AR(1)'s
            plan = (MeshPlan(t4, {kind: "t"}) if kind == "T"
                    else MeshPlan(kp, {kind: "p"}).with_all_K("k"))
            (e0, l0), (e1, l1) = planned_vs_unsharded(make, plan)
            res["real"][name] = {"elbo": (float(e0), float(e1)),
                                 "state": [(a.numpy(), b.numpy()) for a, b in zip(l0, l1)]}
    finally:
        for k in LAZY:
            del os.environ[k]

    # seq's three exchanges on plain operands
    from alan_tpu_torch.ops.logmmexp import chain_logmmexp
    res["seq"] = {}
    for name, ms in chain_operands().items():
        x = torch.tensor(ms, requires_grad=True)
        W = torch.tensor(np.random.default_rng(9).standard_normal(ms.shape[:1] + ms.shape[2:]),
                         dtype=torch.float32)
        ref = chain_logmmexp(x)
        gref, = torch.autograd.grad((ref * W).sum(), x)
        for method in ("all_gather", "ring", "butterfly"):
            out = seq.chain_logmmexp_sharded(x, t4, "t", method=method)
            g, = torch.autograd.grad((out * W).sum(), x)
            res["seq"][name, method] = {
                "out": out.detach().numpy(), "bitwise": torch.equal(out, ref),
                "grad_bitwise": torch.equal(g, gref),
                "grad_err": float((g - gref).abs().max())}
        auto = seq.chain_logmmexp_sharded(x, t4, "t")
        res["seq"][name, "auto_is_butterfly"] = torch.equal(
            auto, seq.chain_logmmexp_sharded(x, t4, "t", method="butterfly"))

    # the collective inventory
    def qem_call(problem, plan):
        step, state = train.qem(problem, K_TINY, lr=0.1, device="cpu", mesh_plan=plan)
        return lambda: step(state, seeded_generator(0, "cpu"))
    res["inventory"] = {
        "planned": collective_audit.audit_step(qem_call(tiny(), plan_kp), (),
                                               expect=("all-reduce",)),
        "plain": collective_audit.collective_inventory(qem_call(tiny(), None)),
        "t_sharded": collective_audit.collective_inventory(qem_call(covid_shaped(), plan_t)),
    }
    from alan_tpu_torch.models import movielens as tml
    ps, data, cov = tml.load_data_covariates(0, device="cpu")
    head = tml.generate_problem(ps, data, cov, "qem", device="cpu")
    step, state = train.qem(head, 30, lr=0.1, device="cpu", mesh_plan=plan_kp)
    res["inventory"]["headline"] = collective_audit.collective_inventory(
        lambda: step(state, seeded_generator(4, "cpu")))

    # an undividable dim warns once; strict raises
    x = DT(torch.zeros((6, 3)), ("K_z",))
    plan = MeshPlan(k4, {"K_z": "k"})
    with warnings.catch_warnings(record=True) as w1:
        warnings.simplefilter("always")
        out = plan.constrain(x)
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        plan.constrain(x)
    try:
        MeshPlan(k4, {"K_z": "k"}, strict=True).constrain(x)
        strict = None
    except ValueError as e:
        strict = str(e)
    res["undividable"] = {
        "warned": any("does not divide" in str(m.message) for m in w1),
        "warned_again": any("does not divide" in str(m.message) for m in w2),
        "dims": out.dims, "strict": strict}

    # scan_steps and vmap_runs of a planned step against its eager loop
    res["planned_scan"] = {}
    for name, (problem, plan, K) in {"tiny_qem_kp": (tiny(), plan_kp, K_TINY),
                                     "covid_qem_t": (covid_shaped(), plan_t, K_COVID)}.items():
        step, state0 = train.qem(problem, K, lr=0.1, device="cpu", mesh_plan=plan)
        with strict_views(plan):
            st_e, el_e = train._eager(step, 3, state0, seeded_generator(7, "cpu"))
            st_s, el_s = train.scan_steps(step, 3)(state0, seeded_generator(7, "cpu"))
            runs_e = [train._eager(step, 3, state0, train.run_generator(8, r, "cpu"))
                      for r in range(2)]
            st_r, el_r = train.vmap_runs(step, 3, 2)(state0, 8)
        leaves = lambda st: train._flatten(st)[0]
        res["planned_scan"][name] = {
            "scan_bitwise": torch.equal(el_e, el_s) and all(
                torch.equal(a, b) for a, b in zip(leaves(st_e), leaves(st_s))),
            "runs_bitwise": all(
                torch.equal(el_r[r], e) and all(
                    torch.equal(a, b) for a, b in zip(leaves(train.run_state(st_r, r)),
                                                      leaves(st)))
                for r, (st, e) in enumerate(runs_e)),
            "elbos": el_s.numpy().copy()}

    # the cases fed alan_tpu's particles, once the test process wrote them
    inp = _wait_for_inputs(out_dir)
    # the tiny problem, QEM and VI, under plate + K sharding
    (sP, sQ), elbo = _qem(tiny(), K_TINY, plan_kp, inp["tiny_qem"]["sample"])
    res["tiny_qem"] = {"elbo": float(elbo), "state": _state((sP, sQ), "qem_params"),
                       "dtensor_free": not any(
                           type(v.data) is not torch.Tensor for v in sQ["qem_params"].values())}
    (_, sQu), elbo_u = _qem(tiny(), K_TINY, None, inp["tiny_qem"]["sample"])
    res["tiny_qem"]["unsharded"] = {"elbo": float(elbo_u),
                                    "state": _state((None, sQu), "qem_params")}
    (_, sQ, _), elbo = _vi(tiny(OptParam), K_TINY, plan_kp, inp["tiny_vi"]["noise"])
    res["tiny_vi"] = {"elbo": float(elbo), "state": _state((None, sQ), "opt")}
    env = {"ALAN_TPU_MATMUL_MIN_K": "2", "ALAN_TPU_MATMUL_MIN_MN": "1"}
    os.environ.update(env)
    try:
        from alan_tpu_torch.ops import contraction
        calls = []
        orig = contraction.pairwise_logsumexp_contract
        contraction.pairwise_logsumexp_contract = lambda *a: (calls.append(1), orig(*a))[1]
        (_, sQ), elbo = _qem(tiny(), K_TINY, plan_kp, inp["tiny_qem"]["sample"])
        contraction.pairwise_logsumexp_contract = orig
    finally:
        for k in env:
            del os.environ[k]
    res["tiny_qem_matmul"] = {"elbo": float(elbo), "state": _state((None, sQ), "qem_params"),
                              "matmul_calls": len(calls)}

    # Split over plate_1 composed with plate_2 + K sharding
    plan_split = MeshPlan(kp, {"plate_2": "p"}).with_all_K("k")
    (_, sQ), elbo = _qem(tiny(), K_TINY, plan_split, inp["tiny_qem"]["sample"],
                         strategy=Split("plate_1", 8))
    res["split"] = {"elbo": float(elbo), "state": _state((None, sQ), "qem_params")}

    # the covid-shaped problem with its T dim sharded
    c0 = seq.CALLS
    (_, sQ), elbo = _qem(covid_shaped(), K_COVID, plan_t, inp["covid_qem"]["sample"])
    res["covid_qem"] = {"elbo": float(elbo), "state": _state((None, sQ), "qem_params"),
                        "seq_calls": seq.CALLS - c0}
    (_, sQ, _), elbo = _vi(covid_shaped(2, 8, "opt"), K_COVID_VI, plan_t,
                           inp["covid_vi"]["noise"])
    res["covid_vi"] = {"elbo": float(elbo), "state": _state((None, sQ), "opt")}

    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(from_port(res), f)
    torch.distributed.destroy_process_group()


# ---- the test process: alan_tpu's side and the group --------------------------------

def _jax_side():
    """``alan_tpu``'s unsharded steps and the particles they drew."""
    import jax
    import jax.numpy as jnp
    from alan_tpu import (BoundPlate as JBoundPlate, Data as JData, Normal as JNormal,
                          OptParam as JOptParam, Plate as JPlate, Problem as JProblem,
                          QEMParam as JQEMParam, named as jnamed, train as jtrain)
    from alan_tpu.ops.logmmexp import chain_logmmexp as jchain
    from alan_tpu.sampler import PermutationSampler as JPerm
    from test_sharding import _covid_shaped_problem

    def jtiny(param):
        P = JPlate(mu=JNormal(0., 1.), plate_1=JPlate(
            z=JNormal("mu", 1.), plate_2=JPlate(obs=JNormal("z", 1.))))
        Q = JPlate(mu=JNormal(param(0.), param(1.)), plate_1=JPlate(
            z=JNormal(param(0.), param(1.)), plate_2=JPlate(obs=JData())))
        ps = {"plate_1": 16, "plate_2": 4}
        rng = np.random.default_rng(0)
        data = {"obs": jnamed(jnp.asarray(rng.standard_normal((16, 4)), jnp.float32),
                              "plate_1", "plate_2")}
        return JProblem(JBoundPlate(P, ps), JBoundPlate(Q, ps), data)

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if tree is None:
            return None
        return ("DT", np.asarray(tree.data), tuple(tree.dims))

    def draws(jprob, K, reparam, key, stateQ):
        # under jax.jit: eager JAX compiles every op of the draw on its own
        return jax.jit(lambda k, st: jprob.Q._sample(
            K, reparam, JPerm, jprob.all_platedims, k, state=st)[0])(key, stateQ)

    def qem(jprob, K, seed):
        step, state = jtrain.qem(jprob, K, lr=0.1)
        key = jax.random.key(seed)
        tree = draws(jprob, K, False, key, state[1])
        (_, sQ), elbo = step(state, key)
        return {"sample": plain(tree), "elbo": float(elbo),
                "state": {k: np.asarray(v.data) for k, v in sQ["qem_params"].items()}}

    def aligned(p, dims):
        """``p``'s data laid out along ``dims`` (size 1 where it has none)."""
        a = np.moveaxis(np.asarray(p.data), range(len(p.dims)),
                        [sorted(p.dims, key=dims.index).index(d) for d in p.dims])
        return a.reshape([a.shape[sorted(p.dims, key=dims.index).index(d)]
                          if d in p.dims else 1 for d in dims])

    def vi(jprob, K, seed):
        step, state = jtrain.vi(jprob, K, lr=0.01)
        key = jax.random.key(seed)
        tree = draws(jprob, K, True, key, state[1])
        opt = jax.jit(jprob.Q.opt_params)(state[1])

        def noise(t):
            out = {}
            for k, v in t.items():
                if isinstance(v, dict):
                    out[k] = noise(v)
                elif v is not None:
                    loc, scale = (aligned(opt[f"{k}_{p}"], v.dims) for p in ("loc", "scale"))
                    out[k] = ("DT", (np.asarray(v.data) - loc) / scale, tuple(v.dims))
            return out
        (_, sQ, _), elbo = step(state, key)
        return {"noise": noise(tree), "elbo": float(elbo),
                "state": {k: np.asarray(v.data) for k, v in sQ["opt"].items()}}

    from canonical_parity import quick_compiles
    with quick_compiles():      # the problems' prior draws, op by op
        problems = (jtiny(JQEMParam), jtiny(JOptParam), _covid_shaped_problem(),
                    _covid_shaped_problem(R=2, T=8, param="opt"))
    return {
        "tiny_qem": qem(problems[0], K_TINY, 0),
        "tiny_vi": vi(problems[1], K_TINY, 0),
        "covid_qem": qem(problems[2], K_COVID, 0),
        "covid_vi": vi(problems[3], K_COVID_VI, 1),
        "chains": {k: np.asarray(jax.jit(jchain)(jnp.asarray(v)))
                   for k, v in chain_operands().items()},
    }


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """``(alan_tpu's side, each rank's results)`` of one 4-rank run."""
    d = tmp_path_factory.mktemp("parallel")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         env.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--world", str(WORLD), "--port", str(port), "--dir", str(d)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    try:
        # alan_tpu's side while the workers start and run the cases that
        # do not need its particles
        jside = _jax_side()
        with open(d / "inputs.tmp", "wb") as f:
            pickle.dump({k: jside[k] for k in ("tiny_qem", "tiny_vi", "covid_qem",
                                               "covid_vi")}, f)
        os.replace(d / "inputs.tmp", d / "inputs.pkl")
        for p in procs:
            out, _ = p.communicate(timeout=300)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return jside, ranks


def _close_state(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_workers_started_their_group(group):
    _, ranks = group
    assert all(r["initialized"] for r in ranks)


def test_initialize_is_a_noop_without_an_address(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("case,rtol,atol", [
    ("tiny_qem", 1e-4, 1e-4), ("tiny_vi", 1e-3, 1e-4), ("tiny_qem_matmul", 1e-4, 1e-4),
    ("split", 1e-3, 1e-4), ("covid_qem", 1e-3, 1e-4), ("covid_vi", 1e-3, 1e-4)])
def test_planned_step_matches_jax(group, case, rtol, atol):
    """A planned step on 4 ranks against ``alan_tpu``'s unsharded step on
    the same particles: the ELBO within 1e-4, the state at
    ``tests/test_sharding.py``'s tolerances; every rank alike."""
    jside, ranks = group
    want = jside[{"tiny_qem_matmul": "tiny_qem", "split": "tiny_qem"}.get(case, case)]
    for r in ranks:
        got = r[case]
        assert np.isclose(got["elbo"], want["elbo"], rtol=1e-4, atol=1e-4), (
            got["elbo"], want["elbo"])
        _close_state(got["state"], want["state"], rtol, atol)
    assert len({r[case]["elbo"] for r in ranks}) == 1
    if case == "tiny_qem":
        assert ranks[0][case]["dtensor_free"]
        un = ranks[0][case]["unsharded"]
        assert np.isclose(un["elbo"], want["elbo"], rtol=1e-4, atol=1e-4)
    if case == "tiny_qem_matmul":
        assert ranks[0][case]["matmul_calls"] > 0
    if case == "covid_qem":
        assert all(r[case]["seq_calls"] == 1 for r in ranks)


@pytest.mark.parametrize("name", ["grouped_qem", "grouped_vi", "covid_nRs", "ar1"])
def test_card_paths_on_four_ranks(group, name):
    """``chip_smoke.py``'s planned paths at small sizes on 4 ranks against
    the unsharded port from one generator seed: ELBO within 1e-5
    relative, state within 1e-4."""
    _, ranks = group
    for r in ranks:
        got = r["real"][name]
        assert np.isclose(*got["elbo"], rtol=1e-5, atol=0), got["elbo"]
        for a, b in got["state"]:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["plain", "spread"])
@pytest.mark.parametrize("method", ["all_gather", "ring", "butterfly"])
def test_sequence_sharded_chain(group, name, method):
    jside, ranks = group
    ref = jside["chains"][name]
    for r in ranks:
        got = r["seq"][name, method]
        np.testing.assert_allclose(got["out"], ref, rtol=1e-4, atol=1e-4)
        assert got["grad_err"] < 1e-3
    if method == "butterfly":
        assert all(r["seq"][name, method]["bitwise"] for r in ranks)
        assert all(r["seq"][name, method]["grad_bitwise"] for r in ranks)
        assert all(r["seq"][name, "auto_is_butterfly"] for r in ranks)


def test_collective_inventory_and_scaling_model(group):
    _, ranks = group
    inv = ranks[0]["inventory"]
    assert inv["planned"]["all-reduce"]["count"] >= 1
    assert inv["planned"]["all-reduce"]["bytes"] > 0
    assert inv["plain"] == {}
    t = inv["t_sharded"]
    assert ("all-gather" in t) or ("collective-permute" in t), t
    rep = collective_audit.scaling_report(1e9, inv["planned"], chip_counts=(8, 16, 64))
    effs = [rep[str(n)]["efficiency"] for n in (8, 16, 64)]
    assert all(0.0 < e <= 1.0 for e in effs)
    assert effs[0] >= effs[1] >= effs[2]


def test_no_fullplate_gather_in_the_headline_step(group):
    """A full-plate gather of the K/2-sharded z x x product would be 1.6 MB
    (``tests/test_sharding.py:374-408``)."""
    _, ranks = group
    for r in ranks:
        ag = r["inventory"]["headline"].get("all-gather", {"count": 0, "bytes": 0})
        assert ag["bytes"] < 1_000_000, r["inventory"]["headline"]


@pytest.mark.parametrize("name", ["tiny_qem_kp", "covid_qem_t"])
def test_planned_scan_steps_and_runs_are_the_eager_loop(group, name):
    """``scan_steps`` and ``vmap_runs`` of a planned step (plate + K on
    {k: 2, p: 2}; the T-sharded chain on {t: 4}) on 4 ranks: bitwise the
    eager planned loop from the same generators, every rank alike."""
    _, ranks = group
    for r in ranks:
        got = r["planned_scan"][name]
        assert got["scan_bitwise"] and got["runs_bitwise"], name
        assert np.all(np.isfinite(got["elbos"]))
    assert all(np.array_equal(r["planned_scan"][name]["elbos"],
                              ranks[0]["planned_scan"][name]["elbos"]) for r in ranks)


def test_undividable_dim_warns_once_and_strict_raises(group):
    _, ranks = group
    for r in ranks:
        u = r["undividable"]
        assert u["warned"] and not u["warned_again"]
        assert u["dims"] == ("K_z",)
        assert u["strict"] is not None and "does not divide" in u["strict"]


def test_world_size_one_plan_is_bitwise(tmp_path):
    """One rank: the planned step is the unsharded step, bitwise, on the
    tiny problem and on ``chip_smoke.py``'s planned paths at small sizes
    (``mesh_single_card``'s plans)."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    old = {k: os.environ.get(k) for k in LAZY}
    try:
        kp = make_mesh({"k": 1, "p": 1}, device_type="cpu")
        t1 = make_mesh({"t": 1}, device_type="cpu")
        plan = MeshPlan(kp, {"plate_1": "p"}).with_all_K("k")
        (sP0, sQ0), e0 = _qem(tiny(), K_TINY, None, gen_seed=0)
        (sP1, sQ1), e1 = _qem(tiny(), K_TINY, plan, gen_seed=0)
        assert torch.equal(e0, e1)
        for k in sQ0["qem_params"]:
            assert torch.equal(sQ0["qem_params"][k].data, sQ1["qem_params"][k].data), k
        os.environ.update(LAZY)
        for name, (make, kind) in real_models().items():
            plan = (MeshPlan(t1, {kind: "t"}) if kind in ("nDs", "T")
                    else MeshPlan(kp, {kind: "p"}).with_all_K("k"))
            c0 = seq.CALLS
            (e0, l0), (e1, l1) = planned_vs_unsharded(make, plan)
            assert torch.equal(e0, e1), name
            assert all(torch.equal(a, b) for a, b in zip(l0, l1)), name
            assert (seq.CALLS > c0) == (kind in ("nDs", "T")), name
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    a = ap.parse_args()
    worker(a.rank, a.world, a.port, a.dir)
