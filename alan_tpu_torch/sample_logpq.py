"""Posterior K-index sampling (counterpart of ``alan_tpu/sample_logpq.py``):
the logPQ traversal once more, drawing joint indices over the K-dims plate
by plate, each plate's conditioned on the indices drawn above it.  A plate
that holds a Timeseries draws its timeseries K-dims first, by FFBS
(``reduce_ks.sample_Ks_timeseries``), then its other K-dims by the reverse
replay (``reduce_ks.sample_Ks``).
"""
from __future__ import annotations

from typing import Optional

from .dims import dims_of, dt_index
from .ir.plate import Plate, update_scope
from .logpq import lp_getter
from .reduce_ks import _lagged_traj, sample_Ks, sample_Ks_timeseries


def logPQ_sample(name: Optional[str], P: Plate, Q: Plate, sample: dict,
                 inputs_params: dict, data: dict, extra_log_factors: dict,
                 scope: dict, active_platedims: list, all_platedims: dict,
                 groupvarname2Kdim: dict, varname2groupvarname: dict,
                 sampler, computation_strategy, indices: dict, N_dim: str,
                 num_samples: int, keygen, noise=None):
    """Returns ``indices`` extended by every K-dim of this plate and the
    plates below it.  ``noise``, an iterator of Gumbel tensors, gives the
    draws' noise in the order of the traversal: at each plate the FFBS
    draws, then the replay's (``reduce_ks``)."""
    assert isinstance(P, Plate) and isinstance(Q, Plate)
    assert isinstance(indices, dict)

    if name is not None:
        active_platedims = [*active_platedims, name]

    scope = update_scope(scope, inputs_params)
    scope = update_scope(scope, sample)

    lps, non_ts_Ks, ts_Ks, ts_init_Ks = lp_getter(
        P=P, Q=Q, sample=sample, inputs_params=inputs_params,
        data=data, extra_log_factors=extra_log_factors, scope=scope,
        active_platedims=active_platedims, all_platedims=all_platedims,
        groupvarname2Kdim=groupvarname2Kdim,
        varname2groupvarname=varname2groupvarname, sampler=sampler,
        computation_strategy=computation_strategy)

    # timeseries K-dims first (FFBS needs the factors' Kinit dims unindexed)
    if len(ts_Ks) > 0:
        indices = sample_Ks_timeseries(lps, ts_Ks, ts_init_Ks, N_dim, num_samples,
                                       name, indices, keygen, noise=noise)

    # condition every factor on the indices drawn so far.  A chain factor's
    # Kinit dim is the previous step's particle: the parent init particle
    # at t=0, the chain's own particle at t-1 after, so it is indexed by the
    # lagged trajectory, not by the init index repeated over T
    curr_for_init = {}
    for kd, ki in zip(ts_Ks, ts_init_Ks):
        curr_for_init.setdefault(ki, []).append(kd)
    lps = [_index_all(lp, indices, curr_for_init, name) for lp in lps]

    if len(non_ts_Ks) > 0:
        indices = sample_Ks(lps, non_ts_Ks, N_dim, num_samples, keygen, indices,
                            noise=noise)

    for childname, childQ in Q.grouped_prog.items():
        if isinstance(childQ, Plate):
            childP = P.flat_prog[childname]
            assert isinstance(childP, Plate)
            indices = logPQ_sample(
                name=childname, P=childP, Q=childQ,
                sample=Q.grouped_get(sample, childname),
                data=Q.grouped_get(data, childname),
                inputs_params=inputs_params.get(childname) or {},
                extra_log_factors=extra_log_factors.get(childname) or {},
                scope=scope,
                active_platedims=active_platedims,
                all_platedims=all_platedims,
                groupvarname2Kdim=groupvarname2Kdim,
                varname2groupvarname=varname2groupvarname,
                sampler=sampler,
                computation_strategy=computation_strategy,
                indices=indices,
                N_dim=N_dim,
                num_samples=num_samples,
                keygen=keygen,
                noise=noise)
    return indices


def _index_all(lp, indices, curr_for_init=None, T_dim=None):
    if getattr(lp, "__lazy_dt__", False):
        # a lazy factored log-prob: the replay indexes into the factor, so
        # the dense form is needed here
        lp = lp.materialize()
    for dim in [d for d in dims_of(lp) if d in indices]:
        idx = indices[dim]
        if (curr_for_init and dim in curr_for_init and T_dim is not None
                and T_dim in dims_of(lp)):
            # the lagged chain axis: the chain's trajectory shifted one step,
            # the init particle's index at t=0
            currs = curr_for_init[dim]
            kd = next((k for k in currs if k in dims_of(lp)), currs[0])
            idx = _lagged_traj(indices[kd], idx, T_dim)
        lp = dt_index(lp, dim, idx)
    return lp
