"""Sample: K particles per latent drawn from Q, and what the logPQ
contraction gives from them (counterpart of ``alan_tpu/sample.py``; the
port has the ELBO in its three forms, VI, RWS and no-grad, and the
moments).

``elbo_vi()`` is differentiable through the reparameterised draws, the
reference's own torch idiom: ``(-sample.elbo_vi()).backward()`` gives the
VI gradient of every opt param.  ``elbo_rws()`` takes the detached draws,
so its gradient reaches the opt params through the log-densities alone.
The computation strategy defaults to ``no_checkpoint`` everywhere:
``alan_tpu``'s ``checkpoint`` (rematerialisation in the backward pass) is
not ported yet, and it changes no value.

Posterior moments are gradients of the ELBO with respect to injected
zero-valued log-factors ``J`` (the source-term trick, ``alan_tpu``'s
``sample.py:205-221``): ``torch.autograd.grad`` of the loss with respect to
zero tensors that require grad.
"""
from __future__ import annotations

import torch

from .dims import DT, as_dt, dims_of, sum_pos, detach
from .ir.plate import tensordict2tree, flatten_tree
from .logpq import logPQ_plate
from .split import no_checkpoint
from .moments import RawMoment, dt_moments_mixin
from .utils import detach_tree


class Sample:
    def __init__(self, problem, sample: dict, groupvarname2Kdim: dict,
                 sampler, reparam: bool, states=None):
        self.problem = problem
        self.groupvarname2Kdim = groupvarname2Kdim
        self.sampler = sampler
        self.reparam = reparam
        # optional (stateP, stateQ) override for functional training steps
        self._states = states if states is not None else (None, None)
        if reparam:
            self.reparam_sample = sample
        self.detached_sample = detach_tree(sample)

    @property
    def P(self):
        return self.problem.P

    @property
    def Q(self):
        return self.problem.Q

    @property
    def all_platedims(self):
        return self.problem.all_platedims

    def _elbo(self, sample, extra_log_factors, computation_strategy):
        extra_log_factors = {f"__elf_{i}": sum_pos(v)
                             for i, v in enumerate((extra_log_factors or {}).values())}
        extra_log_factors = tensordict2tree(self.P.plate, extra_log_factors)
        lp = logPQ_plate(
            name=None,
            P=self.P.plate,
            Q=self.Q.plate,
            sample=sample,
            inputs_params=self.problem.inputs_params(*self._states),
            data=self.problem.data,
            extra_log_factors=extra_log_factors,
            scope={},
            active_platedims=[],
            all_platedims=self.all_platedims,
            groupvarname2Kdim=self.groupvarname2Kdim,
            varname2groupvarname=self.problem.Q.plate.varname2groupvarname(),
            sampler=self.sampler,
            computation_strategy=computation_strategy)
        assert dims_of(lp) == ()
        return lp.data if isinstance(lp, DT) else lp

    def elbo_vi(self, computation_strategy=no_checkpoint):
        """The ELBO through the reparameterised draws."""
        if not self.reparam:
            raise Exception(
                "To compute the VI ELBO you must construct a reparameterised "
                "sample with problem.sample(K, generator, reparam=True)")
        return self._elbo(self.reparam_sample, None, computation_strategy)

    def elbo_rws(self, computation_strategy=no_checkpoint):
        """The ELBO of the detached draws."""
        return self._elbo(self.detached_sample, None, computation_strategy)

    def elbo_nograd(self, computation_strategy=no_checkpoint):
        with torch.no_grad():
            return self._elbo(self.detached_sample, None, computation_strategy)

    # ---- moments via source terms ----------------------------------------
    def _moment_specs(self, moms):
        assert isinstance(moms, list)
        for (varnames, m) in moms:
            if not isinstance(m, RawMoment):
                raise Exception("sample.moments requires RawMoments (E[f(x)])")

        flat_sample = flatten_tree(self.detached_sample)
        set_platenames = set(self.all_platedims)

        specs = []
        for i, (varnames, m) in enumerate(moms):
            samples = [flat_sample[vn] for vn in varnames]
            platedimss = [[d for d in dims_of(s) if d in set_platenames] for s in samples]
            longest = sorted(platedimss, key=len)[-1]
            for pd in platedimss:
                assert set(pd).issubset(longest), \
                    "moment variables must be hierarchically nested in plates"
            f = detach(as_dt(m.f(*samples)))
            dims = tuple(longest)
            shape = tuple([self.all_platedims[d] for d in dims]) + f.pos_shape
            # keyed by position: the same (varnames, moment) may appear twice
            specs.append((i, dims, shape, f))
        return specs

    def _source_term_loss(self, specs, computation_strategy):
        """(J list, loss): zero source terms that require grad, and the ELBO
        with ``f * J`` added for every moment; the loss value is the plain
        ELBO and its gradient with respect to each J is the moment."""
        device = self.problem.device
        Js = [torch.zeros(shape, device=device, requires_grad=True)
              for (_, _, shape, _) in specs]
        elfs = {key_: f * DT(J, dims) for ((key_, dims, _, f), J) in zip(specs, Js)}
        return Js, self._elbo(self.detached_sample, elfs, computation_strategy)

    def _moments_uniform_input(self, moms, computation_strategy=no_checkpoint):
        return self._moments_and_elbo(moms, computation_strategy)[1]

    def _moments_and_elbo(self, moms, computation_strategy=no_checkpoint):
        """(elbo, moments) in one forward and one backward pass."""
        specs = self._moment_specs(moms)
        Js, elbo = self._source_term_loss(specs, computation_strategy)
        grads = torch.autograd.grad(elbo, Js)
        return elbo.detach(), [DT(g, dims) for (_, dims, _, _), g in zip(specs, grads)]

    moments = dt_moments_mixin
