"""QEM training (counterpart of ``qem`` in ``alan_tpu/train.py``).

One QEM step draws K particles per latent from Q, makes one forward and one
backward pass that give the ELBO and every posterior moment (the source
terms, ``Sample._moments_and_elbo``), and applies the moment-matching update
to P's and Q's QEM parameters.  ``qem`` returns ``(step, state0)``:

* ``step(state, generator)`` draws the particles with a ``torch.Generator``
  on the problem's device;
* ``step(state, sample=tree)`` takes a ready-made particle tree instead (the
  parity tests give both packages the same draws this way).

Each returns ``(new_state, elbo)``.
"""
from __future__ import annotations

import re

import torch

from .sample import Sample
from .sampler import PermutationSampler
from .split import no_checkpoint
from .utils import assert_full_f32, resolve_device


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
    device = resolve_device(device)
    if problem.device != device:
        raise ValueError(f"problem lies on {problem.device}, not {device}")
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
