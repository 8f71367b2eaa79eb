"""Importance samples, their extension over enlarged plates and the
predictive log-likelihood (counterpart of ``alan_tpu/importance.py``).

``Sample.importance_sample(N, generator)`` draws N joint posterior samples
of every latent (each carries the dim ``N``); ``extend`` draws the latents
and data of enlarged plates from the prior given them, and
``ExtendedImportanceSample.predictive_ll`` scores held-out data.
"""
from __future__ import annotations

from .dims import as_dt, dims_of, logmeanexp_dims, sum_dims
from .ir.plate import flatten_tree, tensordict2tree
from .moments import dt_moments_mixin
from .utils import KeyGen


class AbstractImportanceSample:
    def dump(self):
        """The importance samples as a flat dict of dimmed tensors (the
        ``N`` dim indexes the joint samples)."""
        return dict(self.samples_flatdict)

    def _moments_uniform_input(self, moms):
        assert isinstance(moms, list)
        result = []
        for varnames, m in moms:
            samples = tuple(self.samples_flatdict[vn] for vn in varnames)
            result.append(m.from_samples(samples, self.Ndim))
        return result

    moments = dt_moments_mixin

    def _base_scope(self, overridden):
        """P's inputs and params at its state: the scope of the prior
        draws and log-densities, less the inputs given anew over the
        extended plates."""
        return {k: v for k, v in
                self.problem.P.inputs_params_flat_named(self._states[0]).items()
                if k not in overridden}


class ImportanceSample(AbstractImportanceSample):
    def __init__(self, problem, samples_tree, Ndim, states=(None, None)):
        self.problem = problem
        self.samples_tree = samples_tree
        self.samples_flatdict = flatten_tree(samples_tree)
        self.Ndim = Ndim
        self._states = states

    def extend(self, extended_platesizes: dict, extended_inputs=None,
               generator=None, noise=None):
        """Enlarge the plates to ``extended_platesizes`` (a plate left out
        keeps its size) and draw what the enlarged plates add from the
        prior, given the importance samples; ``extended_inputs`` are the
        covariates over the enlarged plates.  The prior draws come from
        ``generator``; ``noise``, standard-normal tensors in draw order,
        replaces it for the draws with a reparameterised form (a
        Timeseries's roll-forward takes one a step)."""
        assert isinstance(extended_platesizes, dict)
        extended_platesizes = dict(extended_platesizes)
        extended_inputs = {k: as_dt(v) for k, v in (extended_inputs or {}).items()}

        for name, size in self.problem.all_platedims.items():
            if name not in extended_platesizes:
                extended_platesizes[name] = size
        assert set(extended_platesizes) == set(self.problem.all_platedims)

        all_inputs_params = tensordict2tree(self.problem.P.plate, extended_inputs)

        # the draws carry N beside the extended plates
        N_size = next(v.dim_size(self.Ndim) for v in self.samples_flatdict.values()
                      if self.Ndim in v.dims)
        extended_platesizes = {**extended_platesizes, self.Ndim: N_size}

        noise = None if noise is None else iter(noise)
        extended_sample = self.problem.P.plate.sample_extended(
            sample=self.samples_tree,
            name=None,
            scope=self._base_scope(extended_inputs),
            inputs_params=all_inputs_params,
            original_platedims=self.problem.all_platedims,
            extended_platedims=extended_platesizes,
            active_extended_platedims=[],
            Ndim=self.Ndim,
            keygen=KeyGen(generator),
            original_data=self.problem.data,
            noise=noise,
        )
        if noise is not None and next(noise, None) is not None:
            raise ValueError("more injected standard-normal noise than draws")
        return ExtendedImportanceSample(self.problem, extended_sample, self.Ndim,
                                        extended_platesizes, extended_inputs,
                                        states=self._states)


class ExtendedImportanceSample(AbstractImportanceSample):
    def __init__(self, problem, samples_tree, Ndim, extended_platedims,
                 extended_inputs, states=(None, None)):
        self.problem = problem
        self.samples_tree = samples_tree
        self.samples_flatdict = flatten_tree(samples_tree)
        self.Ndim = Ndim
        self.extended_platedims = extended_platedims
        self.extended_inputs = extended_inputs
        self._states = states

    def predictive_ll(self, data: dict):
        """The predictive log-likelihood of held-out data, per data
        variable: ``logmeanexp_N(sum ll_all - sum ll_train)``, where
        ``data`` covers the extended plates (a variable left out keeps its
        training data)."""
        assert isinstance(data, dict)
        extended_data = {k: as_dt(v) for k, v in data.items()}
        original_data = flatten_tree(self.problem.data)

        for name, tensor in original_data.items():
            if name not in extended_data:
                extended_data[name] = tensor
        assert set(extended_data) == set(original_data)

        lls_train, lls_all = self.problem.P.plate.predictive_ll(
            sample=self.samples_tree,
            name=None,
            scope=self._base_scope(self.extended_inputs),
            inputs_params=tensordict2tree(self.problem.P.plate,
                                          dict(self.extended_inputs)),
            original_platedims=self.problem.all_platedims,
            extended_platedims=self.extended_platedims,
            original_data=original_data,
            extended_data=extended_data,
        )
        assert set(lls_all) == set(lls_train)

        result = {}
        for varname in lls_all:
            ll_all = lls_all[varname]
            ll_train = lls_train[varname]
            dims_all = [d for d in dims_of(ll_all) if d != self.Ndim]
            dims_train = [d for d in dims_of(ll_train) if d != self.Ndim]
            assert len(dims_all) == len(dims_train)
            if dims_all:
                ll_all = sum_dims(ll_all, tuple(dims_all))
                ll_train = sum_dims(ll_train, tuple(dims_train))
            result[varname] = logmeanexp_dims(ll_all - ll_train, (self.Ndim,))
        return result
