"""Training steps (counterpart of ``alan_tpu/train.py``): VI, RWS and QEM,
their global-K baselines, the captured loop of steps and the ``fit`` loop.

* ``vi``  -- reparameterised draws; the gradient of the ELBO with respect to
  every opt param flows through the draws and the log-densities.
* ``rws`` -- detached draws; the gradient flows through log P and log Q
  only (wake-sleep).  P's opt params ascend the ELBO, Q's descend it.
* ``qem`` -- detached draws, one forward and one backward pass that give
  the ELBO and every posterior moment (the source terms,
  ``Sample._moments_and_elbo``), and the moment-matching update of P's and
  Q's QEM parameters.

Each factory returns ``(step, state0)``, and ``step(state, generator)``
returns ``(new_state, elbo)``: the particles come from a
``torch.Generator`` on the problem's device.  ``vi`` and ``rws`` keep
``state = (stateP, stateQ, opt_state)``, as ``alan_tpu``; the optimizer is
``torch.optim.Adam(lr)`` unless one is given, whose defaults (betas 0.9,
0.999, eps 1e-8) are ``optax.adam``'s, and ``opt_state`` is its
``state_dict()``, built up front (step 0, zero moments) so that every
step's state has one structure.  A step leaves the state it was given
untouched.  ``global_vi``, ``global_rws`` and ``global_qem`` take the same
steps on the non-MP ELBO of K joint particles (``sample_nonmp.py``).

``scan_steps`` runs ``n`` steps as one loop and ``vmap_runs`` runs
independent loops: on the card as CUDA graphs, captured once and replayed
with no host dispatch, on the CPU as the eager loop, with the same draws.
A planned step is captured under its plan, its collectives inside the
graph.

``elbo_fn``, ``vi``, ``rws`` and ``qem`` take ``mesh_plan=`` (a
``parallel.mesh.MeshPlan``, ``alan_tpu/train.py:33-47``): the step runs
under the plan, its particles laid out by it, and returns its state and
ELBO whole.  The global-K methods refuse a plan.

The parity tests give both packages the same draws: ``qem`` and ``rws``
steps take a ready-made particle tree (``step(state, sample=tree)``), and a
``vi`` step takes the standard noise of each reparameterised draw
(``step(state, noise=tree)``), from which it rebuilds the draws under
autograd.
"""
from __future__ import annotations

import contextlib
import re
import time
import warnings

import torch

from .dims import DT
from .parallel.mesh import full
from .sample import Sample
from .sampler import IndependentSampler, PermutationSampler
from .split import no_checkpoint
from .utils import assert_full_f32, fold_seed, resolve_device, seeded_generator


def _on_device(problem, device):
    device = resolve_device(device)
    if problem.device != device:
        raise ValueError(f"problem lies on {problem.device}, not {device}")
    return device


def _draws(problem, K, reparam, sampler, stateQ, generator, sample, noise):
    """``(particle tree, groupvarname2Kdim)``: K particles per latent drawn
    from Q at ``stateQ`` with ``generator``, or the given ``sample`` (a
    particle tree, detached draws only), or rebuilt from ``noise``
    (reparameterised draws only; where Q permutes a parent's particles, the
    permutations come from ``generator``, and without one the draw
    raises)."""
    if sample is not None:
        if reparam or generator is not None or noise is not None:
            raise ValueError("a particle tree replaces the draws of a "
                             "detached step only, and alone")
        return sample, problem.Q.plate.groupvarname2Kdim(K)
    if noise is not None and not reparam:
        raise ValueError("noise replaces reparameterised draws only")
    if generator is None and noise is None:
        raise ValueError("pass a generator, a sample or noise")
    return problem.Q._sample(K, reparam, sampler, problem.all_platedims,
                             generator, state=stateQ, noise=noise)


def _plan_active(mesh_plan):
    """Run under the plan, so the engine routes e.g. the timeseries chain
    to its T-sharded implementation."""
    return mesh_plan.active() if mesh_plan is not None else contextlib.nullcontext()


def _constrained(tree, mesh_plan):
    """The particle tree laid out by the plan: each rank keeps its shard of
    the draws every rank made alike (``alan_tpu``'s ``_make_sample``)."""
    return tree if mesh_plan is None else mesh_plan.constrain_tree(tree)


def _planned(step, mesh_plan):
    """``step`` run under ``mesh_plan``, its new state and ELBO returned
    whole (plain tensors, the same on every rank), so that the next step
    draws from a plain state as the unsharded step does.
    ``step.mesh_plan`` names the plan."""
    if mesh_plan is None:
        return step

    def planned(state, *args, **kwargs):
        with mesh_plan.active():
            return full(step(state, *args, **kwargs))
    planned.mesh_plan = mesh_plan
    return planned


def elbo_fn(problem, K, reparam=True, sampler=PermutationSampler,
            computation_strategy=no_checkpoint, mesh_plan=None):
    """``f(stateP, stateQ, generator=None, sample=None, noise=None) ->
    elbo``: draw K particles per latent from Q at ``stateQ`` and evaluate
    the ELBO at ``(stateP, stateQ)``, differentiable in the opt params.
    The draws come from ``generator``, ``sample`` or ``noise``
    (``_draws``).  With a ``MeshPlan`` the particles, inputs and data are
    laid out by it and the engine runs sharded; the ELBO comes back
    whole."""
    def f(stateP, stateQ, generator=None, sample=None, noise=None):
        with _plan_active(mesh_plan):
            sample, gv2K = _draws(problem, K, reparam, sampler, stateQ, generator,
                                  sample, noise)
            sample = _constrained(sample, mesh_plan)
            s = Sample(problem, sample, gv2K, sampler, reparam, states=(stateP, stateQ))
            elbo = s.elbo_vi(computation_strategy) if reparam else \
                s.elbo_rws(computation_strategy)
            return full(elbo)
    return f


def opt_leaves(stateP, stateQ, dtype=None):
    """``(leaves, stateP', stateQ')``: fresh leaf tensors (in ``dtype``, if
    given) that require grad, one for every opt param of P and then of Q,
    and the two states that read them.  ``elbo_fn`` at those states and
    ``torch.autograd.grad`` with respect to ``leaves`` give the gradient of
    every opt param."""
    leaves, states = [], []
    for state in (stateP, stateQ):
        opt = {}
        for k, v in state["opt"].items():
            leaf = v.data.detach().to(dtype or v.data.dtype).clone().requires_grad_(True)
            leaves.append(leaf)
            opt[k] = DT(leaf, v.dims)
        states.append({**state, "opt": opt})
    return leaves, states[0], states[1]


def _clone_opt_state(opt_state):
    return {"state": {i: {k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in st.items()}
                      for i, st in opt_state["state"].items()},
            "param_groups": [dict(g) for g in opt_state["param_groups"]]}


def _optimizer_step(make_optimizer, opt_state, leaves, grads, stateP, stateQ):
    """One optimizer step on copies: ``(newP, newQ, new_opt_state)``."""
    if leaves:
        opt = make_optimizer(leaves)
        opt.load_state_dict(_clone_opt_state(opt_state))
        for leaf, g in zip(leaves, grads):
            leaf.grad = torch.zeros_like(leaf) if g is None else g
        with warnings.catch_warnings():
            # a capturable optimizer warns when it steps outside a graph;
            # the eager step and the captured one are the same step here
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            opt.step()
        opt_state = opt.state_dict()
    out, it = [], iter(leaves)
    for state in (stateP, stateQ):
        opt = {k: DT(next(it).detach(), v.dims) for k, v in state["opt"].items()}
        out.append({**state, "opt": opt})
    return out[0], out[1], opt_state


def _initial_opt_state(opt):
    """``opt``'s state dict with an Adam's state built as its first step
    would build it (step 0, zero moments), so that every step's state has
    one structure and a CUDA graph can capture step 0 as well as step 1.
    Other optimizers keep the state they have."""
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        for group in opt.param_groups:
            on_card = group["capturable"] or group["fused"]
            for p in group["params"]:
                zero = lambda: torch.zeros_like(p, memory_format=torch.preserve_format)
                state = {"step": torch.zeros((), dtype=torch.float32, device=p.device)
                         if on_card else torch.tensor(0.0),
                         "exp_avg": zero(), "exp_avg_sq": zero()}
                if group["amsgrad"]:
                    state["max_exp_avg_sq"] = zero()
                opt.state[p] = state
    return opt.state_dict()


def _gradient_factory(problem, f, lr, optimizer, device, signs, mesh_plan=None):
    """``(step, state0)`` of a gradient method on the ELBO
    ``f(stateP, stateQ, generator, **draws)``: ``signs(nP, grads)`` turns
    its gradients into the ones the optimizer descends.  The default
    optimizer is Adam, capturable (its step count on the card) where the
    problem lies on the card."""
    device = _on_device(problem, device)
    if optimizer is None:
        capturable = device.type == "cuda"
        optimizer = lambda params: torch.optim.Adam(params, lr=lr,
                                                    capturable=capturable)

    def step(state, generator=None, **draws):
        assert_full_f32(device)
        stateP, stateQ, opt_state = state
        leaves, sP, sQ = opt_leaves(stateP, stateQ)
        elbo = f(sP, sQ, generator, **draws)
        grads = (torch.autograd.grad(elbo, leaves, allow_unused=True)
                 if leaves and elbo.requires_grad else [None] * len(leaves))
        grads = signs(len(stateP["opt"]), full(list(grads)))
        newP, newQ, opt_state = _optimizer_step(optimizer, opt_state, leaves,
                                                grads, stateP, stateQ)
        return (newP, newQ, opt_state), elbo.detach()

    stateP, stateQ = problem.P.state(), problem.Q.state()
    leaves, _, _ = opt_leaves(stateP, stateQ)
    opt_state = _initial_opt_state(optimizer(leaves)) if leaves else None
    return _planned(step, mesh_plan), (stateP, stateQ, opt_state)


def _neg(g):
    return None if g is None else -g


def _ascend_all(nP, grads):
    """VI: every opt param ascends the ELBO."""
    return [_neg(g) for g in grads]


def _wake_sleep(nP, grads):
    """RWS: P's opt params (the first ``nP``) ascend the ELBO, Q's descend it."""
    return [_neg(g) for g in grads[:nP]] + list(grads[nP:])


def vi(problem, K: int, lr=0.01, optimizer=None, sampler=PermutationSampler,
       computation_strategy=no_checkpoint, device="cuda", mesh_plan=None):
    """Reparameterised-VI step factory: every opt param ascends the ELBO.
    ``optimizer`` maps a list of leaf tensors to a ``torch.optim``
    optimizer (default ``torch.optim.Adam(params, lr=lr)``).
    ``step(state, generator)`` or ``step(state, noise=tree)``.  With a
    ``MeshPlan`` the step runs sharded (``parallel/mesh.py``)."""
    return _gradient_factory(
        problem, elbo_fn(problem, K, True, sampler, computation_strategy, mesh_plan),
        lr, optimizer, device, _ascend_all, mesh_plan)


def rws(problem, K: int, lr=0.01, optimizer=None, sampler=PermutationSampler,
        computation_strategy=no_checkpoint, device="cuda", mesh_plan=None):
    """Reweighted-wake-sleep step factory: P's opt params ascend the ELBO
    and Q's descend it (the reference's ``maximize=True`` Adam on P and
    ``maximize=False`` on Q).  ``step(state, generator)`` or
    ``step(state, sample=tree)``.  With a ``MeshPlan`` the step runs
    sharded."""
    return _gradient_factory(
        problem, elbo_fn(problem, K, False, sampler, computation_strategy, mesh_plan),
        lr, optimizer, device, _wake_sleep, mesh_plan)


def _schedule(lr):
    """None for a fixed ``lr``, else ``t -> lr_t`` (``alan_tpu``'s
    ``train.py:175-191``): ``"1/t"`` is Robbins-Monro averaging from the
    start; ``"<lr0>/t@<T0>"`` keeps ``lr0`` until iteration ``T0`` and then
    decays as ``1/(t - T0 + 1/lr0)``, continuous at the switch."""
    if callable(lr):
        return lr
    if not isinstance(lr, str):
        return None
    if lr == "1/t":
        return lambda t: 1.0 / (t + 1.0)
    m = re.fullmatch(r"([0-9.]+)/t@([0-9]+)", lr)
    if not m:
        raise ValueError(f"unknown qem lr schedule {lr!r} "
                         f"(expected '1/t' or '<lr0>/t@<T0>')")
    lr0, T0 = float(m.group(1)), float(m.group(2))

    def delayed(t):
        # ``t`` is a tensor on the problem's device (a number becomes one):
        # ``torch.where``, not a branch on its value, which would be a host
        # sync, and a CUDA graph cannot capture one
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.where(t < T0, lr0, 1.0 / (t - T0 + 1.0 / lr0))
    return delayed


def qem(problem, K: int, lr=0.1, sampler=PermutationSampler,
        computation_strategy=no_checkpoint, device="cuda", mesh_plan=None):
    """QEM step factory.  ``lr`` is a float, a callable ``t -> lr_t`` or a
    schedule string (see ``_schedule``); with a schedule the state is
    ``((stateP, stateQ), t)``, ``t`` a 0-d float32 tensor on the problem's
    device (as ``alan_tpu``'s), so that a captured step reads the iteration
    from the card.  ``device`` must be the problem's device.  With a
    ``MeshPlan`` the step runs sharded; its state and ELBO come back
    whole."""
    device = _on_device(problem, device)
    schedule = _schedule(lr)

    def step(state, generator=None, sample=None):
        if (generator is None) == (sample is None):
            raise ValueError("pass exactly one of generator and sample")
        assert_full_f32(device)
        if schedule is not None:
            state, t = state
            lr_t = schedule(t)
        else:
            lr_t = lr
        stateP, stateQ = state
        if sample is None:
            sample, gv2K = problem.Q._sample(K, False, sampler,
                                             problem.all_platedims, generator,
                                             state=stateQ)
        else:
            gv2K = problem.Q.plate.groupvarname2Kdim(K)
        sample = _constrained(sample, mesh_plan)
        s = Sample(problem, sample, gv2K, sampler, False, states=(stateP, stateQ))
        rmP = problem.P.qem_flat_list_rmkeys
        rmQ = problem.Q.qem_flat_list_rmkeys
        if rmP or rmQ:
            elbo, moms = s._moments_and_elbo(list(rmP) + list(rmQ),
                                             computation_strategy)
            momP, momQ = moms[:len(rmP)], moms[len(rmP):]
        else:
            elbo = s.elbo_nograd(computation_strategy)
            momP = momQ = None
        with torch.no_grad():
            newP = problem.P._updated_qem_state(lr_t, s, computation_strategy,
                                                state=stateP, moments=momP)
            newQ = problem.Q._updated_qem_state(lr_t, s, computation_strategy,
                                                state=stateQ, moments=momQ)
        if schedule is not None:
            return ((newP, newQ), t + 1.0), elbo
        return (newP, newQ), elbo

    state0 = (problem.P.state(), problem.Q.state())
    if schedule is not None:
        state0 = (state0, torch.zeros((), dtype=torch.float32, device=device))
    return _planned(step, mesh_plan), state0


# ---- the non-MP global-K baselines -------------------------------------------

def _make_nonmp(problem, K, reparam, stateP, stateQ, generator=None, sample=None,
                noise=None):
    """A ``SampleNonMP`` of K joint particles (``IndependentSampler``: one
    global K-dim) drawn from Q at ``stateQ`` (``_draws``), evaluated at
    ``(stateP, stateQ)``."""
    from .sample_nonmp import SampleNonMP
    tree, gv2K = _draws(problem, K, reparam, IndependentSampler, stateQ,
                        generator, sample, noise)
    s = SampleNonMP(problem, tree, gv2K, reparam)
    s._states = (stateP, stateQ)
    return s


def global_elbo_fn(problem, K, reparam=True):
    """``f(stateP, stateQ, generator=None, sample=None, noise=None) ->
    elbo``: the non-MP (global single-K, IWAE-style) ELBO, the reference's
    ``global_*`` methods' objective, differentiable in the opt params."""
    def f(stateP, stateQ, generator=None, sample=None, noise=None):
        s = _make_nonmp(problem, K, reparam, stateP, stateQ, generator, sample, noise)
        return s._elbo(s.reparam_sample if reparam else s.detached_sample)
    return f


def _no_plan(mesh_plan, method):
    if mesh_plan is not None:
        raise ValueError(f"{method} takes no MeshPlan: the global-K baselines "
                         "run unsharded")


def global_vi(problem, K: int, lr=0.01, optimizer=None, device="cuda", mesh_plan=None):
    """VI on the global-K ELBO: ``vi``'s step and state, one K-dim."""
    _no_plan(mesh_plan, "global_vi")
    return _gradient_factory(problem, global_elbo_fn(problem, K, True), lr,
                             optimizer, device, _ascend_all)


def global_rws(problem, K: int, lr=0.01, optimizer=None, device="cuda", mesh_plan=None):
    """RWS on the global-K ELBO: ``rws``'s step and state, one K-dim."""
    _no_plan(mesh_plan, "global_rws")
    return _gradient_factory(problem, global_elbo_fn(problem, K, False), lr,
                             optimizer, device, _wake_sleep)


def global_qem(problem, K: int, lr=0.1, device="cuda", mesh_plan=None):
    """QEM on the global-K importance weights: the moments are the
    self-normalised weights' averages over the K joint particles
    (``SampleNonMP.moments``), ``lr`` a float.  ``step(state, generator)``
    or ``step(state, sample=tree)``."""
    _no_plan(mesh_plan, "global_qem")
    device = _on_device(problem, device)

    def step(state, generator=None, sample=None):
        if (generator is None) == (sample is None):
            raise ValueError("pass exactly one of generator and sample")
        assert_full_f32(device)
        stateP, stateQ = state
        with torch.no_grad():
            s = _make_nonmp(problem, K, False, stateP, stateQ, generator, sample)
            newP = problem.P._updated_qem_state(lr, s, no_checkpoint, state=stateP)
            newQ = problem.Q._updated_qem_state(lr, s, no_checkpoint, state=stateQ)
            elbo = s._elbo(s.detached_sample)
        return (newP, newQ), elbo

    return step, (problem.P.state(), problem.Q.state())


# ---- the captured loop ------------------------------------------------------------

def _flatten(tree):
    """``(tensor leaves, spec)`` of a state: tuples, lists and dicts are
    walked, a ``DT`` or a tensor is a leaf, anything else a constant of
    the spec, from which ``_unflatten`` rebuilds the tree."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("tensor",)
        if isinstance(x, DT):
            leaves.append(x.data)
            return ("DT", x.dims)
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(v)) for k, v in x.items()))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        return ("const", x)
    return leaves, walk(tree)


def _unflatten(spec, leaves, dims=lambda ds: ds):
    """The tree of ``spec`` with ``leaves`` in order; ``dims`` maps each
    DT's dims (``vmap_runs`` puts its ``runs`` dim in front)."""
    it = iter(leaves)

    def build(sp):
        kind = sp[0]
        if kind == "tensor":
            return next(it)
        if kind == "DT":
            return DT(next(it), dims(sp[1]))
        if kind == "dict":
            return {k: build(v) for k, v in sp[1]}
        if kind in ("tuple", "list"):
            out = [build(v) for v in sp[1]]
            return tuple(out) if kind == "tuple" else out
        return sp[1]
    return build(spec)


def _eager(step, n_steps, state, generator):
    elbos = []
    for _ in range(n_steps):
        state, elbo = step(state, generator)
        elbos.append(elbo)
    return state, torch.stack(elbos)


class _Graph:
    """``unroll`` steps captured as one CUDA graph.  The state lives in
    static buffers, which every replay reads and overwrites with the new
    state; the ELBOs go into ``elbos`` at a counter kept on the card; the
    draws come from a generator of the graph's own (registered with it, so
    that each replay advances its Philox offset as the eager steps
    would)."""

    def __init__(self, step, leaves, spec, generator, unroll, elbos, counter):
        device = generator.device
        self.static = [x.clone() for x in leaves]
        self.generator = torch.Generator(device=device)
        # warm-up on a side stream, on copies of the state and the
        # generator: it builds the kernels, the planner's paths and the
        # libraries' handles, and leaves the caller's draws untouched
        warm = torch.Generator(device=device)
        warm.set_state(generator.get_state())
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _eager(step, unroll, _unflatten(spec, [x.clone() for x in leaves]), warm)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)

        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        # every tensor the graph reads that lies outside its pool is held
        # as long as the graph: a freed one's memory would be reused
        self.positions = torch.arange(unroll, device=device)
        fault = None
        with torch.cuda.graph(self.graph):
            state, out = _eager(step, unroll, _unflatten(spec, self.static),
                                self.generator)
            new, new_spec = _flatten(state)
            if new_spec != spec or [x.shape for x in new] != [x.shape for x in self.static]:
                fault = ("the step's new state differs in structure or shape from "
                         "the state it was given (an optimizer that builds its "
                         "state at its first step, say), so it cannot be carried "
                         "from one replay to the next")
            else:
                inputs = {x.untyped_storage().data_ptr() for x in self.static}
                # a new leaf that shares memory with an input is copied out
                # before any input is overwritten
                new = [x.clone() if x.untyped_storage().data_ptr() in inputs else x
                       for x in new]
                for dst, src in zip(self.static, new):
                    dst.copy_(src)
                elbos.index_copy_(0, counter + self.positions, out.reshape(-1))
                counter.add_(unroll)
        if fault is not None:
            raise ValueError(f"scan_steps: {fault}")

    def replay(self, leaves, generator):
        """Load ``leaves`` into the static state (or keep the state of the
        previous replay where ``leaves`` is None) and replay once."""
        if leaves is not None:
            for dst, src in zip(self.static, leaves):
                dst.copy_(src)
        self.generator.set_state(generator.get_state())
        self.graph.replay()
        generator.set_state(self.generator.get_state())


class _Scan:
    """``scan_steps``'s loop: ``run(state, generator) -> (state,
    elbos[n_steps])``.  See ``scan_steps``."""

    def __init__(self, step, n_steps, unroll):
        if n_steps < 1 or unroll < 1:
            raise ValueError(f"n_steps ({n_steps}) and unroll ({unroll}) must be >= 1")
        self.step, self.n_steps, self.unroll = step, n_steps, min(unroll, n_steps)
        self._graphs = {}
        #: seconds the last call spent capturing (0.0 when it replayed
        #: graphs captured before): the counterpart of XLA's compile
        self.capture_seconds = 0.0

    def __call__(self, state, generator):
        if generator.device.type != "cuda":
            return _eager(self.step, self.n_steps, state, generator)
        entry = self._start(state, generator)
        return self._finish(entry)

    def _start(self, state, generator):
        """Capture (at a state of a new structure or shape) and launch the
        replays of one run on the current stream; returns what
        ``_finish`` reads."""
        leaves, spec = _flatten(state)
        device = generator.device
        for x in leaves:
            if x.device.type != "cuda":
                raise ValueError(
                    f"scan_steps captures a state on the card; a leaf lies on "
                    f"{x.device} (an optimizer built with capturable=False "
                    f"keeps its step count on the host, say)")
        key = (repr(spec), tuple((tuple(x.shape), x.dtype, x.device) for x in leaves))
        entry = self._graphs.get(key)
        self.capture_seconds = 0.0
        if entry is None:
            t0 = time.perf_counter()
            elbos = torch.empty(self.n_steps, dtype=torch.float32, device=device)
            counter = torch.zeros((), dtype=torch.int64, device=device)
            full, rem = divmod(self.n_steps, self.unroll)
            graphs = [_Graph(self.step, leaves, spec, generator, self.unroll,
                             elbos, counter)] * full
            if rem:
                graphs.append(_Graph(self.step, leaves, spec, generator, rem,
                                     elbos, counter))
            entry = self._graphs[key] = (spec, graphs, elbos, counter)
            self.capture_seconds = time.perf_counter() - t0
        spec, graphs, elbos, counter = entry
        counter.zero_()
        last = None
        for g in graphs:
            # a graph starts from the state its predecessor left, which for
            # the remainder's graph lies in the full graphs' buffers
            g.replay(leaves if last is None else
                     (None if g is last else last.static), generator)
            last = g
        return spec, last, elbos

    @staticmethod
    def _finish(entry):
        spec, last, elbos = entry
        # clones: the next replay overwrites the graph's buffers
        return _unflatten(spec, [x.clone() for x in last.static]), elbos.clone()


def scan_steps(step, n_steps: int, unroll: int | None = None):
    """``n_steps`` training steps as one replayed loop (counterpart of
    ``alan_tpu/train.py:316-350``): ``step(state, generator) -> (state,
    elbo)`` of any factory becomes ``run(state, generator) -> (state,
    elbos[n_steps])``, whose draws are exactly those of the eager loop
    ``for i in range(n_steps): state, e = step(state, generator)`` from the
    same generator state, which it advances as that loop would.

    On the card: ``unroll`` steps (default 1) are captured as one CUDA
    graph, after a warm-up on a side stream, and replayed
    ``n_steps // unroll`` times (a remainder gets a graph of its own), so no
    step is dispatched from the host.  The state is copied into the
    graph's buffers, each replay leaves the new state there and writes its
    ELBOs into an ``(n_steps,)`` tensor, and the state returned is cloned
    out of them.  The graphs are kept per structure and shapes of the
    state, so a second call replays without capturing
    (``run.capture_seconds`` says how long the last call captured).  A
    capture that fails raises: there is no fallback to the eager loop.
    On the CPU, ``run`` is that eager loop.  A planned step (``mesh_plan=``)
    is captured under its plan: the warm-up runs each of its collectives
    once (so the communicators exist before the capture) and the graph
    holds them, so every rank replays the same collectives in the same
    order."""
    return _Scan(step, n_steps, 1 if unroll is None else unroll)


def run_generator(seed: int, r: int, device) -> torch.Generator:
    """The generator of run ``r`` of ``vmap_runs`` given the caller's
    ``seed``: seeded ``fold_seed(seed, r)``, the port's stand-in for
    ``alan_tpu``'s ``fold_in(key, r)``."""
    return seeded_generator(fold_seed(seed, r), device)


def run_state(states, r: int):
    """Run ``r``'s state out of ``vmap_runs``'s stacked states."""
    leaves, spec = _flatten(states)
    return _unflatten(spec, [x[r] for x in leaves], lambda ds: ds[1:])


class _Runs:
    """``vmap_runs``'s runs: ``many(state0, seed) -> (states, elbos)``.
    See ``vmap_runs``."""

    def __init__(self, step, n_steps, n_runs, unroll):
        if n_runs < 1:
            raise ValueError(f"n_runs ({n_runs}) must be >= 1")
        self.runs = [_Scan(step, n_steps, unroll) for _ in range(n_runs)]
        self._streams = None

    @property
    def capture_seconds(self):
        return sum(run.capture_seconds for run in self.runs)

    def __call__(self, state0, seed: int):
        leaves, _ = _flatten(state0)
        if not leaves:
            raise ValueError("vmap_runs takes the runs' device from the state's "
                             "tensors, and this state has none")
        device = leaves[0].device
        gens = [run_generator(seed, r, device) for r in range(len(self.runs))]
        # every rank must run a planned step's collectives in one order:
        # its runs replay one after another on the current stream
        if device.type != "cuda" or getattr(self.runs[0].step, "mesh_plan", None):
            outs = [run(state0, g) for run, g in zip(self.runs, gens)]
        else:
            main = torch.cuda.current_stream(device)
            if self._streams is None:
                self._streams = [torch.cuda.Stream(device) for _ in self.runs]
            entries = []
            for run, g, s in zip(self.runs, gens, self._streams):
                s.wait_stream(main)
                with torch.cuda.stream(s):
                    entries.append(run._start(state0, g))
            for s in self._streams:
                main.wait_stream(s)
            outs = [_Scan._finish(e) for e in entries]
        states = [_flatten(state)[0] for state, _ in outs]
        spec = _flatten(outs[0][0])[1]
        stacked = [torch.stack(xs) for xs in zip(*states)]
        return (_unflatten(spec, stacked, lambda ds: ("runs", *ds)),
                torch.stack([e for _, e in outs]))


def vmap_runs(step, n_steps: int, n_runs: int, unroll: int = 1):
    """``n_runs`` independent training runs of ``n_steps`` each
    (counterpart of ``alan_tpu/train.py:353-379``):
    ``many(state0, seed) -> (states, elbos)``.  Run ``r`` draws from its
    own generator, ``run_generator(seed, r, device)``, and equals
    ``scan_steps(step, n_steps)(state0, run_generator(seed, r, device))``.
    Every tensor leaf of ``states`` carries a leading ``n_runs`` axis (a
    ``DT`` a leading ``runs`` dim; ``run_state`` takes one run out) and
    ``elbos`` is ``(n_runs, n_steps)``.

    On the card each run is a captured loop of its own (``scan_steps``:
    its own graphs, memory pool and generator), replayed on a stream of
    its own, so the runs overlap on the device, as ``vmap`` lets small-K
    runs share the chip in ``alan_tpu``; a planned step's runs replay one
    after another on the current stream.  On the CPU the runs go one after
    another."""
    return _Runs(step, n_steps, n_runs, unroll)


def fit(problem, method="vi", K=10, iters=100, lr=None, generator=None,
        fuse_iters=False, device="cuda", **kwargs):
    """Run ``iters`` steps of ``method`` (``"qem"``, ``"vi"``, ``"rws"`` or
    a global-K baseline, ``"global_vi"``, ``"global_rws"``,
    ``"global_qem"``) from the problem's state, write the final state back
    into its BoundPlates, and return the ELBOs of the iterations.  The
    particles of every step come from ``generator`` (default: seeded 0),
    whose state advances from step to step (``alan_tpu`` folds the
    iteration into its key instead).  ``fuse_iters=True`` runs the
    iterations through ``scan_steps`` (one captured loop on the card, the
    same draws).  ``kwargs`` go to the step factory."""
    factories = {"vi": (vi, 0.01), "rws": (rws, 0.01), "qem": (qem, 0.1),
                 "global_vi": (global_vi, 0.01), "global_rws": (global_rws, 0.01),
                 "global_qem": (global_qem, 0.1)}
    if method not in factories:
        raise ValueError(f"unknown method {method!r}")
    factory, default_lr = factories[method]
    step, state = factory(problem, K, lr=default_lr if lr is None else lr,
                          device=device, **kwargs)
    if generator is None:
        generator = seeded_generator(0, problem.device)
    if fuse_iters:
        state, elbos = scan_steps(step, iters)(state, generator)
    else:
        state, elbos = _eager(step, iters, state, generator)
    if method in ("qem", "global_qem"):
        if len(state) == 2 and not isinstance(state[1], dict):
            state, _ = state          # a schedule's ((stateP, stateQ), t)
        stateP, stateQ = state
    else:
        stateP, stateQ, _ = state
    problem.P.set_state(stateP)
    problem.Q.set_state(stateQ)
    return elbos
