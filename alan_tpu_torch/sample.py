"""Sample: K particles per latent drawn from Q, and what the logPQ
contraction gives from them (counterpart of ``alan_tpu/sample.py``): the
ELBO in its three forms, VI, RWS and no-grad, the posterior moments, the
marginal weights of the particles and importance samples.

``elbo_vi()`` is differentiable through the reparameterised draws, the
reference's own torch idiom: ``(-sample.elbo_vi()).backward()`` gives the
VI gradient of every opt param.  ``elbo_rws()`` takes the detached draws,
so its gradient reaches the opt params through the log-densities alone.
The computation strategy (``split.py``) defaults to ``alan_tpu``'s:
``checkpoint`` for ``elbo_vi``, ``elbo_rws``, ``elbo_nograd``,
``marginals`` and ``importance_sample`` (each plate body recomputed in the
backward pass instead of kept), ``no_checkpoint`` for the moments; a
``Split`` chunks one plate.  No strategy changes a value beyond the order
of the sums.

Posterior moments are gradients of the ELBO with respect to injected
zero-valued log-factors ``J`` (the source-term trick, ``alan_tpu``'s
``sample.py:205-221``): ``torch.autograd.grad`` of the loss with respect to
zero tensors that require grad.  The marginals are the same gradient with
respect to a source term over each latent's K-dim and plates.

``importance_sample(N, generator)`` draws N joint samples by replaying the
contraction backwards (``sample_logpq.py``, ``reduce_ks.sample_Ks``) under
``torch.no_grad()``; injected Gumbel noise (``noise=``, an iterable of
tensors in draw order) can stand in for the generator.
"""
from __future__ import annotations

import torch

from .dims import DT, as_dt, dims_of, sum_pos, detach, dt_index
from .ir.plate import tensordict2tree, flatten_tree, empty_tree
from .logpq import logPQ_plate
from .sample_logpq import logPQ_sample
from .split import checkpoint, no_checkpoint
from .moments import RawMoment, dt_moments_mixin
from .marginals import Marginals
from .importance import ImportanceSample
from .utils import KeyGen, detach_tree


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
        # under a MeshPlan the inputs, parameters and data are laid out as
        # well as the particles: one left plain meets the sharded factors
        # replicated, and a plate-sharded product with it is formed whole
        # (``alan_tpu``'s ``sample.py:61-72``)
        from .parallel.mesh import active_plan
        plan = active_plan()
        inputs_params = self.problem.inputs_params(*self._states)
        data = self.problem.data
        if plan is not None:
            inputs_params = plan.constrain_tree(inputs_params)
            data = plan.constrain_tree(data)
        lp = logPQ_plate(
            name=None,
            P=self.P.plate,
            Q=self.Q.plate,
            sample=sample,
            inputs_params=inputs_params,
            data=data,
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

    def elbo_vi(self, computation_strategy=checkpoint):
        """The ELBO through the reparameterised draws."""
        if not self.reparam:
            raise Exception(
                "To compute the VI ELBO you must construct a reparameterised "
                "sample with problem.sample(K, generator, reparam=True)")
        return self._elbo(self.reparam_sample, None, computation_strategy)

    def elbo_rws(self, computation_strategy=checkpoint):
        """The ELBO of the detached draws."""
        return self._elbo(self.detached_sample, None, computation_strategy)

    def elbo_nograd(self, computation_strategy=checkpoint):
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
        with ``f * J`` (``J`` where ``f`` is None) added for every spec
        ``(key, dims, shape, f)``; the loss value is the plain ELBO and its
        gradient with respect to each J is the moment, or the marginal."""
        device = self.problem.device
        Js = [torch.zeros(shape, device=device, requires_grad=True)
              for (_, _, shape, _) in specs]
        elfs = {key_: DT(J, dims) if f is None else f * DT(J, dims)
                for ((key_, dims, _, f), J) in zip(specs, Js)}
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

    # ---- marginals ------------------------------------------------------
    def _marginal_idxs(self, joints, computation_strategy):
        for joint in joints:
            if not isinstance(joint, tuple):
                raise Exception("Arguments to marginals must be tuples of groupvarnames")
            if len(joint) < 2:
                raise Exception("joints in marginals must have length >= 2")
            for gvn in joint:
                if gvn not in self.groupvarname2Kdim:
                    raise Exception(
                        "Arguments to marginals must be groupvarnames (for a "
                        "variable in a Group, use the Group's name)")

        univariates = tuple(frozenset([v]) for v in self.groupvarname2Kdim)
        joints = univariates + tuple(frozenset(j) for j in joints)

        gvn2platenames = self.problem.Q.plate.groupvarname2platenames()
        K = self._K_size()

        specs = []   # (frozenset of groupvarnames, dims, shape, f=None)
        for gvns_frozen in joints:
            gvns = tuple(gvns_frozen)
            active_platenames = gvn2platenames[gvns[0]]
            for gvn in gvns[1:]:
                if set(active_platenames) != set(gvn2platenames[gvn]):
                    raise Exception("Joint marginals across different plates don't make sense")
            dims = tuple([*[self.groupvarname2Kdim[gvn] for gvn in gvns],
                          *active_platenames])
            shape = tuple(K if d.startswith("K_") else self.all_platedims[d] for d in dims)
            specs.append((gvns_frozen, dims, shape, None))

        Js, loss = self._source_term_loss(specs, computation_strategy)
        grads = torch.autograd.grad(loss, Js)
        return {gvns: DT(g, dims) for (gvns, dims, _, _), g in zip(specs, grads)}

    def _K_size(self):
        v2g = self.problem.Q.plate.varname2groupvarname()
        for vn, v in flatten_tree(self.detached_sample).items():
            return v.dim_size(self.groupvarname2Kdim[v2g[vn]])
        raise Exception("no latents")

    def update_qem_params(self, lr: float, computation_strategy=no_checkpoint):
        """One QEM update of P's and then Q's BoundPlate state (in place),
        from this sample's moments (``alan_tpu/sample.py:265``)."""
        self.problem.P._update_qem_params(lr, self, computation_strategy)
        self.problem.Q._update_qem_params(lr, self, computation_strategy)

    def marginals(self, joints=(), computation_strategy=checkpoint):
        """The marginal posterior weights of every latent's particles (and
        of the joints asked for, tuples of groupvarnames): one forward and
        one backward pass."""
        marginals = self._marginal_idxs(joints, computation_strategy)
        samples = flatten_tree(self.detached_sample)
        return Marginals(samples, marginals, self.all_platedims,
                         self.problem.Q.plate.varname2groupvarname())

    # ---- importance sampling ----------------------------------------------
    def _importance_sample_idxs(self, N: int, computation_strategy,
                                generator=None, noise=None):
        if generator is None and noise is None:
            raise ValueError("an importance sample needs a generator or "
                             "injected Gumbel noise")
        N_dim = "N"
        noise = None if noise is None else iter(noise)
        with torch.no_grad():
            indices = logPQ_sample(
                name=None,
                P=self.P.plate,
                Q=self.Q.plate,
                sample=self.detached_sample,
                inputs_params=self.problem.inputs_params(*self._states),
                data=self.problem.data,
                extra_log_factors=empty_tree(self.P.plate),
                scope={},
                active_platedims=[],
                all_platedims=self.all_platedims,
                groupvarname2Kdim=self.groupvarname2Kdim,
                varname2groupvarname=self.problem.Q.plate.varname2groupvarname(),
                sampler=self.sampler,
                computation_strategy=computation_strategy,
                indices={},
                num_samples=N,
                N_dim=N_dim,
                keygen=KeyGen(generator),
                noise=noise)
        if noise is not None and next(noise, None) is not None:
            raise ValueError("more injected Gumbel noise than draws")

        Kdim2gvn = {v: k for k, v in self.groupvarname2Kdim.items()}
        return {Kdim2gvn[k]: v for k, v in indices.items()}, N_dim

    def importance_sample(self, N: int, generator=None,
                          computation_strategy=checkpoint, noise=None):
        """N joint posterior samples of every latent, drawn with
        ``generator`` or with the injected Gumbel ``noise``."""
        indices, N_dim = self._importance_sample_idxs(N, computation_strategy,
                                                      generator, noise)
        samples = index_into_sample(self.detached_sample, indices,
                                    self.groupvarname2Kdim,
                                    self.problem.Q.plate.varname2groupvarname())
        return ImportanceSample(self.problem, samples, N_dim, states=self._states)


def index_into_sample(sample: dict, indices: dict, groupvarname2Kdim: dict,
                      varname2groupvarname: dict):
    """Swap each latent's K-dim for the drawn N-dim."""
    result = {}
    for name, value in sample.items():
        if isinstance(value, dict):
            result[name] = index_into_sample(value, indices, groupvarname2Kdim,
                                             varname2groupvarname)
        else:
            gvn = varname2groupvarname[name]
            result[name] = dt_index(detach(value), groupvarname2Kdim[gvn], indices[gvn])
    return result
