"""Training steps (counterpart of ``alan_tpu/train.py``): VI, RWS and QEM,
and the ``fit`` loop.

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
``state_dict()``.  A step leaves the state it was given untouched.

The parity tests give both packages the same draws: ``qem`` and ``rws``
steps take a ready-made particle tree (``step(state, sample=tree)``), and a
``vi`` step takes the standard noise of each reparameterised draw
(``step(state, noise=tree)``), from which it rebuilds the draws under
autograd.
"""
from __future__ import annotations

import re

import torch

from .dims import DT
from .sample import Sample
from .sampler import PermutationSampler
from .split import no_checkpoint
from .utils import assert_full_f32, resolve_device, seeded_generator


def _on_device(problem, device):
    device = resolve_device(device)
    if problem.device != device:
        raise ValueError(f"problem lies on {problem.device}, not {device}")
    return device


def elbo_fn(problem, K, reparam=True, sampler=PermutationSampler,
            computation_strategy=no_checkpoint):
    """``f(stateP, stateQ, generator=None, sample=None, noise=None) ->
    elbo``: draw K particles per latent from Q at ``stateQ`` and evaluate
    the ELBO at ``(stateP, stateQ)``, differentiable in the opt params.
    The draws come from ``generator``, or are ``sample`` (a particle tree,
    detached draws only), or are rebuilt from ``noise`` (reparameterised
    draws only; where Q permutes a parent's particles, the permutations
    come from ``generator``, and without one the draw raises)."""
    def f(stateP, stateQ, generator=None, sample=None, noise=None):
        if sample is not None:
            if reparam or generator is not None or noise is not None:
                raise ValueError("a particle tree replaces the draws of a "
                                 "detached step only, and alone")
            gv2K = problem.Q.plate.groupvarname2Kdim(K)
        else:
            if noise is not None and not reparam:
                raise ValueError("noise replaces reparameterised draws only")
            if generator is None and noise is None:
                raise ValueError("pass a generator, a sample or noise")
            sample, gv2K = problem.Q._sample(K, reparam, sampler,
                                             problem.all_platedims, generator,
                                             state=stateQ, noise=noise)
        s = Sample(problem, sample, gv2K, sampler, reparam, states=(stateP, stateQ))
        return s.elbo_vi(computation_strategy) if reparam else \
            s.elbo_rws(computation_strategy)
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
        opt.step()
        opt_state = opt.state_dict()
    out, it = [], iter(leaves)
    for state in (stateP, stateQ):
        opt = {k: DT(next(it).detach(), v.dims) for k, v in state["opt"].items()}
        out.append({**state, "opt": opt})
    return out[0], out[1], opt_state


def _gradient_factory(problem, K, reparam, lr, optimizer, sampler,
                      computation_strategy, device, signs):
    """``(step, state0)`` of a gradient method: ``signs(nP, grads)`` turns
    the ELBO's gradients into the ones the optimizer descends."""
    device = _on_device(problem, device)
    if optimizer is None:
        optimizer = lambda params: torch.optim.Adam(params, lr=lr)
    f = elbo_fn(problem, K, reparam, sampler, computation_strategy)

    def step(state, generator=None, **draws):
        assert_full_f32(device)
        stateP, stateQ, opt_state = state
        leaves, sP, sQ = opt_leaves(stateP, stateQ)
        elbo = f(sP, sQ, generator, **draws)
        grads = (torch.autograd.grad(elbo, leaves, allow_unused=True)
                 if leaves and elbo.requires_grad else [None] * len(leaves))
        grads = signs(len(stateP["opt"]), grads)
        newP, newQ, opt_state = _optimizer_step(optimizer, opt_state, leaves,
                                                grads, stateP, stateQ)
        return (newP, newQ, opt_state), elbo.detach()

    stateP, stateQ = problem.P.state(), problem.Q.state()
    leaves, _, _ = opt_leaves(stateP, stateQ)
    opt_state = optimizer(leaves).state_dict() if leaves else None
    return step, (stateP, stateQ, opt_state)


def _neg(g):
    return None if g is None else -g


def vi(problem, K: int, lr=0.01, optimizer=None, sampler=PermutationSampler,
       computation_strategy=no_checkpoint, device="cuda"):
    """Reparameterised-VI step factory: every opt param ascends the ELBO.
    ``optimizer`` maps a list of leaf tensors to a ``torch.optim``
    optimizer (default ``torch.optim.Adam(params, lr=lr)``).
    ``step(state, generator)`` or ``step(state, noise=tree)``."""
    return _gradient_factory(
        problem, K, True, lr, optimizer, sampler, computation_strategy, device,
        lambda nP, grads: [_neg(g) for g in grads])


def rws(problem, K: int, lr=0.01, optimizer=None, sampler=PermutationSampler,
        computation_strategy=no_checkpoint, device="cuda"):
    """Reweighted-wake-sleep step factory: P's opt params ascend the ELBO
    and Q's descend it (the reference's ``maximize=True`` Adam on P and
    ``maximize=False`` on Q).  ``step(state, generator)`` or
    ``step(state, sample=tree)``."""
    return _gradient_factory(
        problem, K, False, lr, optimizer, sampler, computation_strategy, device,
        lambda nP, grads: [_neg(g) for g in grads[:nP]] + list(grads[nP:]))


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
    return lambda t: lr0 if t < T0 else 1.0 / (t - T0 + 1.0 / lr0)


def qem(problem, K: int, lr=0.1, sampler=PermutationSampler,
        computation_strategy=no_checkpoint, device="cuda"):
    """QEM step factory.  ``lr`` is a float, a callable ``t -> lr_t`` or a
    schedule string (see ``_schedule``); with a schedule the state is
    ``((stateP, stateQ), t)``.  ``device`` must be the problem's device."""
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
        state0 = (state0, 0.0)
    return step, state0


def fit(problem, method="vi", K=10, iters=100, lr=None, generator=None,
        fuse_iters=False, device="cuda", **kwargs):
    """Run ``iters`` steps of ``method`` (``"qem"``, ``"vi"`` or ``"rws"``)
    from the problem's state, write the final state back into its
    BoundPlates, and return the ELBOs of the iterations.  The particles of
    every step come from ``generator`` (default: seeded 0), whose state
    advances from step to step (``alan_tpu`` folds the iteration into its
    key instead).  ``kwargs`` go to the step factory."""
    if fuse_iters:
        raise NotImplementedError(
            "fuse_iters (all iterations as one captured loop) is not ported to "
            "alan_tpu_torch yet (ROADMAP queue 1 item 5)")
    factories = {"vi": (vi, 0.01), "rws": (rws, 0.01), "qem": (qem, 0.1)}
    if method not in factories:
        if method in ("global_vi", "global_rws", "global_qem"):
            raise NotImplementedError(
                f"{method} (the non-MP global-K baseline) is not ported to "
                f"alan_tpu_torch yet (ROADMAP queue 1 item 6)")
        raise ValueError(f"unknown method {method!r}")
    factory, default_lr = factories[method]
    step, state = factory(problem, K, lr=default_lr if lr is None else lr,
                          device=device, **kwargs)
    if generator is None:
        generator = seeded_generator(0, problem.device)
    elbos = []
    for _ in range(iters):
        state, elbo = step(state, generator)
        elbos.append(elbo)
    if method == "qem":
        if len(state) == 2 and not isinstance(state[1], dict):
            state, _ = state          # a schedule's ((stateP, stateQ), t)
        stateP, stateQ = state
    else:
        stateP, stateQ, _ = state
    problem.P.set_state(stateP)
    problem.Q.set_state(stateQ)
    return torch.stack(elbos)
