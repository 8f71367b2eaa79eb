"""Proposal samplers: how child particles condition on parent particles
(counterpart of ``alan_tpu/sampler.py``).

Every latent has its own K-dim; when sampling a child from Q, each of the
child's K particles picks the parent particle it conditions on:

* ``PermutationSampler`` permutes the parent particles, so each parent
  particle has exactly one child (the default);
* ``CategoricalSampler`` resamples the parents uniformly with replacement;
* ``IndependentSampler`` is the identity (the non-MP global-K baseline).

``reduce_logQ`` then turns the raw Q log-prob (which carries parent K-dims)
into the mixture-proposal log-prob by log-mean-exp over the parent K-dims;
``IndependentSampler``'s leaves it as it is.
"""
from __future__ import annotations

import torch

from .dims import DT, dims_of, dt_index, bind, logmeanexp_dims


def _kdim_groups(scope: dict, active_platedims):
    """Group scope tensors by their single K-dim."""
    groups: dict = {}
    for varname, tensor in scope.items():
        kdims = [d for d in dims_of(tensor) if d not in active_platedims]
        assert len(kdims) in (0, 1), f"{varname} has K-dims {kdims}"
        kdim = kdims[0] if kdims else None
        groups.setdefault(kdim, {})[varname] = tensor
    return groups


class Sampler:
    @classmethod
    def resample_scope(cls, scope, active_platedims, Kdim, dim_sizes, keygen):
        """Re-index every in-scope parent onto the child's K-dim."""
        new_scope = {}
        for var_Kdim, varname2tensor in _kdim_groups(scope, active_platedims).items():
            if var_Kdim is None:
                new_scope.update(varname2tensor)
                continue
            tensor0 = next(iter(varname2tensor.values()))
            perm = cls.perm(dims=list(dims_of(tensor0)), Kdim=var_Kdim,
                            dim_sizes={**dim_sizes, var_Kdim: tensor0.dim_size(var_Kdim)},
                            generator=keygen())
            for varname, tensor in varname2tensor.items():
                permuted = dt_index(tensor, var_Kdim, perm)  # pos: (K, *pos)
                new_scope[varname] = bind(permuted, Kdim)
        ok = set([Kdim, *active_platedims])
        for t in new_scope.values():
            assert set(dims_of(t)).issubset(ok)
        return new_scope


class SamplerMP(Sampler):
    @staticmethod
    def reduce_logQ(lp: DT, active_platedims, Kdim) -> DT:
        """logmeanexp over parent K-dims: the mixture-proposal correction."""
        parent_Kdims = tuple(d for d in dims_of(lp)
                             if d != Kdim and d not in active_platedims)
        return logmeanexp_dims(lp, parent_Kdims) if parent_Kdims else lp


class PermutationSampler(SamplerMP):
    """Permute the parent particles: argsort of uniforms drawn from the
    traversal's generator."""

    @staticmethod
    def perm(dims, Kdim, dim_sizes, generator) -> DT:
        plate_ds = [d for d in dims if d != Kdim]
        shape = tuple(dim_sizes[d] for d in plate_ds) + (dim_sizes[Kdim],)
        u = torch.rand(shape, generator=generator, device=generator.device)
        # named dims = plates (leading); the trailing K axis is positional
        return DT(torch.argsort(u, dim=-1), tuple(plate_ds))


class CategoricalSampler(SamplerMP):
    """Resample the parent particles uniformly with replacement: integers
    drawn from the traversal's generator."""

    @staticmethod
    def perm(dims, Kdim, dim_sizes, generator) -> DT:
        plate_ds = [d for d in dims if d != Kdim]
        K = dim_sizes[Kdim]
        shape = tuple(dim_sizes[d] for d in plate_ds) + (K,)
        p = torch.randint(0, K, shape, generator=generator, device=generator.device)
        return DT(p, tuple(plate_ds))


class IndependentSampler(Sampler):
    """The identity: child particle k conditions on parent particle k."""

    @staticmethod
    def perm(dims, Kdim, dim_sizes, generator) -> DT:
        return DT(torch.arange(dim_sizes[Kdim], device=generator.device), ())

    @staticmethod
    def reduce_logQ(lp: DT, active_platedims, Kdim) -> DT:
        return lp


samplers = [CategoricalSampler, PermutationSampler]
