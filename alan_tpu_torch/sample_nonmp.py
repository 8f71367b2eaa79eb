"""The non-massively-parallel baseline: one global K-dim, IWAE-style
(counterpart of ``alan_tpu/sample_nonmp.py``).

Q is drawn with ``IndependentSampler``, so particle k of every latent
conditions on particle k of its parents: K joint particles, one K-dim
``"K"`` for all latents.  The ELBO is the log-mean-exp over K of the joint
log P/Q, the moments are the self-normalised importance weights' averages,
and an importance sample draws N of the K joint particles.

``nonmp_moments_streaming`` estimates moments from many more particles
than the card holds at once: chunks of proposals, each from its own
generator, combined by an online log-sum-exp.
"""
from __future__ import annotations

import math

import torch

from .dims import (DT, as_dt, dims_of, dt_index, logsumexp_dims, rename_dim,
                   sum_dims)
from .importance import ImportanceSample
from .ir.data import Data
from .ir.dist import Dist
from .ir.plate import Plate, flatten_tree, update_scope
from .ir.timeseries import Timeseries
from .moments import dt_moments_mixin, uniformise_moment_args
from .reduce_ks import _categorical
from .split import no_checkpoint
from .utils import KeyGen, detach_tree, fold_seed, seeded_generator


class SampleNonMP:
    def __init__(self, problem, sample, groupvarname2Kdim, reparam):
        self.problem = problem
        self.reparam = reparam
        self.Kdim = "K"
        # optional (stateP, stateQ) override for functional training steps
        self._states = (None, None)

        sample = _unify_dims(sample, self.Kdim, set(problem.all_platedims))
        if reparam:
            self.reparam_sample = sample
        self.detached_sample = detach_tree(sample)

    def logpq(self, sample) -> DT:
        """The joint log P - log Q of each of the K particles: a DT over K."""
        result = non_mp_log_prob(
            name=None,
            P=self.problem.P.plate,
            Q=self.problem.Q.plate,
            sample=sample,
            inputs_params=self.problem.inputs_params(*self._states),
            data=self.problem.data,
            scope={},
            active_platedims=[],
            all_platedims=self.problem.all_platedims,
            Kdim=self.Kdim)
        assert dims_of(result) == (self.Kdim,)
        return result

    def _elbo(self, sample):
        lpq = self.logpq(sample)
        K = lpq.dim_size(self.Kdim)
        return logsumexp_dims(lpq, (self.Kdim,)).data - math.log(K)

    def elbo_vi(self):
        if not self.reparam:
            raise Exception("VI ELBO needs a reparameterised sample")
        return self._elbo(self.reparam_sample)

    def elbo_rws(self):
        return self._elbo(self.detached_sample)

    def elbo_nograd(self):
        with torch.no_grad():
            return self._elbo(self.detached_sample)

    def _importance_sample_idxs(self, N: int, generator=None, noise=None):
        """N of the K joint particles drawn by their weights (Gumbel-max,
        ``jax.random.categorical``'s draw); ``noise``, an iterable holding
        one (N, K) Gumbel tensor, replaces the generator's."""
        if generator is None and noise is None:
            raise ValueError("an importance sample needs a generator or "
                             "injected Gumbel noise")
        N_dim = "N"
        noise = None if noise is None else iter(noise)
        with torch.no_grad():
            o = self.logpq(self.detached_sample).order(self.Kdim)
            idx = _categorical(o.data, KeyGen(generator), noise, shape=(N,))
        if noise is not None and next(noise, None) is not None:
            raise ValueError("more injected Gumbel noise than draws")
        return DT(idx, (N_dim,)), N_dim

    def importance_sample(self, N: int, generator=None, noise=None):
        indices, N_dim = self._importance_sample_idxs(N, generator, noise)
        samples = _index_into_non_mp_sample(self.detached_sample, indices, self.Kdim)
        return ImportanceSample(self.problem, samples, N_dim, states=self._states)

    def _moments_uniform_input(self, moms, computation_strategy=None):
        assert isinstance(moms, list)
        lpq = self.logpq(self.detached_sample)
        weights = (lpq - logsumexp_dims(lpq, (self.Kdim,))).exp()
        flat_sample = flatten_tree(self.detached_sample)
        result = []
        for varnames, m in moms:
            args = tuple(flat_sample[vn] for vn in varnames)
            result.append(m.from_marginals(args, weights, self.problem.all_platedims))
        return result

    _moments = dt_moments_mixin
    moments = dt_moments_mixin

    def update_qem_params(self, lr: float):
        """One QEM update of P's and then Q's BoundPlate state (in place)."""
        self.problem.P._update_qem_params(lr, self, computation_strategy=no_checkpoint)
        self.problem.Q._update_qem_params(lr, self, computation_strategy=no_checkpoint)


def _unify_dims(sample, Kdim, platenames):
    """Every latent's own K-dim renamed to the one global ``Kdim``."""
    result = {}
    for k, v in sample.items():
        if isinstance(v, dict):
            result[k] = _unify_dims(v, Kdim, platenames)
        else:
            v = as_dt(v)
            v_Kdims = [d for d in dims_of(v) if d not in platenames]
            assert len(v_Kdims) == 1
            result[k] = rename_dim(v, v_Kdims[0], Kdim)
    return result


def nonmp_moments_streaming(problem, K_total: int, chunk: int, moms, seed: int,
                            reparam: bool = False):
    """Global importance-sampling ``RawMoment`` estimates from ``K_total``
    particles, ``chunk`` at a time: memory O(chunk), and the estimate is
    the single global softmax over the same chunked proposals up to float
    reassociation (``alan_tpu``'s ``lax.scan``, a loop here).  Chunk ``c``
    draws from ``seeded_generator(fold_seed(seed, c), device)``.  Weights
    and weighted moment sums are accumulated under a running max.

    ``moms``: list of ``(varnames, RawMoment)``.  Returns
    ``(moment DT list, elbo)``, elbo = logsumexp(lpq) - log K_total."""
    moms = uniformise_moment_args((moms,))
    n_chunks, rem = divmod(K_total, chunk)
    if rem or n_chunks < 1:
        raise ValueError(f"K_total ({K_total}) must be a positive multiple of "
                         f"chunk ({chunk})")

    def chunk_stats(c):
        gen = seeded_generator(fold_seed(seed, c), problem.device)
        s = problem.sample_nonmp(chunk, gen, reparam=reparam)
        o = s.logpq(s.detached_sample).order(s.Kdim).data         # (chunk,)
        m = torch.amax(o)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        w = DT(torch.exp(o - m), (s.Kdim,))
        flat_sample = flatten_tree(s.detached_sample)
        sums = [mom.from_marginals(tuple(flat_sample[vn] for vn in varnames), w,
                                   problem.all_platedims)
                for varnames, mom in moms]
        return m, torch.sum(w.data), sums

    with torch.no_grad():
        M, Z, S = chunk_stats(0)
        for c in range(1, n_chunks):
            mc, zc, sc = chunk_stats(c)
            Mn = torch.maximum(M, mc)
            a, b = torch.exp(M - Mn), torch.exp(mc - Mn)
            Z = Z * a + zc * b
            S = [DT(s.data * a + x.with_dims_front(list(s.dims)).data * b, s.dims)
                 for s, x in zip(S, sc)]
            M = Mn
        tiny = torch.finfo(torch.float32).tiny
        moments = [DT(s.data / (Z + tiny), s.dims) for s in S]
        elbo = torch.log(Z + tiny) + M - math.log(K_total)
    return moments, elbo


def non_mp_log_prob(name, P, Q, sample, inputs_params, data, scope,
                    active_platedims, all_platedims, Kdim):
    """The flat traversal: sum of log P - log Q over every latent and of
    log P over the data, plates summed, one global K-dim left."""
    if name is not None:
        active_platedims = [*active_platedims, name]

    scope = update_scope(scope, inputs_params)
    scope = update_scope(scope, sample)

    lpqs = []
    for k, distQ in Q.flat_prog.items():
        distP = P.flat_prog[k]
        if isinstance(distP, Timeseries):
            raise NotImplementedError("a Timeseries has no non-MP (global-K) path")
        if isinstance(distQ, Plate):
            lpq = non_mp_log_prob(
                name=k, P=distP, Q=distQ, sample=sample[k],
                inputs_params=inputs_params.get(k) or {},
                data=data[k], scope=scope,
                active_platedims=active_platedims,
                all_platedims=all_platedims, Kdim=Kdim)
            assert set(dims_of(lpq)) == {Kdim}
        elif isinstance(distQ, Data):
            assert isinstance(distP, Dist)
            lpq = sum_dims(distP.log_prob(data[k], scope), tuple(active_platedims),
                           ignore_extra_dims=True)
        else:
            assert isinstance(distQ, Dist)
            lp = sum_dims(distP.log_prob(sample[k], scope), tuple(active_platedims),
                          ignore_extra_dims=True)
            lq = sum_dims(distQ.log_prob(sample[k], scope), tuple(active_platedims),
                          ignore_extra_dims=True)
            lpq = lp - lq
        lpqs.append(lpq)

    total = lpqs[0]
    for x in lpqs[1:]:
        total = total + x
    assert set(dims_of(total)) == {Kdim}
    return total


def _index_into_non_mp_sample(sample, indices, Kdim):
    """Every latent's particles at the drawn ``indices`` (its K-dim swapped
    for their N-dim)."""
    result = {}
    for k, v in sample.items():
        if isinstance(v, dict):
            result[k] = _index_into_non_mp_sample(v, indices, Kdim)
        else:
            result[k] = dt_index(v, Kdim, indices)
    return result
