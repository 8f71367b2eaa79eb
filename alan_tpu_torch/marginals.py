"""Marginal posterior weights over the K particles (counterpart of
``alan_tpu/marginals.py``): ``Sample.marginals()`` reads them off the
gradient of the ELBO with respect to zero source terms over each latent's
K-dim (and its plates), so each sums to one over its K-dims."""
from __future__ import annotations

import torch

from .dims import dims_of, sum_dims
from .moments import dt_moments_mixin


class Marginals:
    def __init__(self, samples: dict, weights: dict, all_platedims: dict,
                 varname2groupvarname: dict):
        """``samples``: varname -> dimmed tensor; ``weights``:
        frozenset[groupvarname] -> weight tensor over (joint) K-dims."""
        self.samples = samples
        self.weights = weights
        self.all_platedims = all_platedims
        self.varname2groupvarname = varname2groupvarname

    def _moments_uniform_input(self, moms):
        assert isinstance(moms, list)
        result = []
        for varnames, m in moms:
            samples = tuple(self.samples[vn] for vn in varnames)
            gvns = frozenset(self.varname2groupvarname[vn] for vn in varnames)
            weights = self.weights[gvns]
            result.append(m.from_marginals(samples, weights, self.all_platedims))
        return result

    moments = dt_moments_mixin

    def ess(self):
        """Effective sample size 1 / sum w^2 of each (joint) marginal, per
        plate cell."""
        result = {}
        platenames = set(self.all_platedims)
        for varnames, w in self.weights.items():
            Kdims = tuple(d for d in dims_of(w) if d not in platenames)
            assert len(Kdims) >= 1
            result[varnames] = 1.0 / sum_dims(w * w, Kdims)
        return result

    def min_ess(self):
        """The smallest ESS of any marginal in any plate cell (a 0-d
        tensor)."""
        return min((torch.min(ess.data) for ess in self.ess().values()), key=float)
