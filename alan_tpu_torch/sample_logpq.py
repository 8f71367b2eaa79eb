"""Posterior K-index sampling (counterpart of ``alan_tpu/sample_logpq.py``
without its timeseries branch): the logPQ traversal once more, drawing joint
indices over the K-dims plate by plate, each plate's conditioned on the
indices drawn above it.

A plate that holds a Timeseries needs forward-filtering backward-sampling
(FFBS), which is not ported yet and raises.
"""
from __future__ import annotations

from typing import Optional

from .dims import dims_of, dt_index
from .ir.plate import Plate, update_scope
from .logpq import lp_getter
from .reduce_ks import sample_Ks


def logPQ_sample(name: Optional[str], P: Plate, Q: Plate, sample: dict,
                 inputs_params: dict, data: dict, extra_log_factors: dict,
                 scope: dict, active_platedims: list, all_platedims: dict,
                 groupvarname2Kdim: dict, varname2groupvarname: dict,
                 sampler, computation_strategy, indices: dict, N_dim: str,
                 num_samples: int, keygen, noise=None):
    """Returns ``indices`` extended by every K-dim of this plate and the
    plates below it.  ``noise``, an iterator of Gumbel tensors, gives the
    draws' noise in the order of the traversal (``reduce_ks.sample_Ks``)."""
    assert isinstance(P, Plate) and isinstance(Q, Plate)
    assert isinstance(indices, dict)

    if name is not None:
        active_platedims = [*active_platedims, name]

    scope = update_scope(scope, inputs_params)
    scope = update_scope(scope, sample)

    lps, non_ts_Ks, ts_Ks, _ = lp_getter(
        P=P, Q=Q, sample=sample, inputs_params=inputs_params,
        data=data, extra_log_factors=extra_log_factors, scope=scope,
        active_platedims=active_platedims, all_platedims=all_platedims,
        groupvarname2Kdim=groupvarname2Kdim,
        varname2groupvarname=varname2groupvarname, sampler=sampler,
        computation_strategy=computation_strategy)

    if len(ts_Ks) > 0:
        raise NotImplementedError(
            f"importance samples of a plate that holds a Timeseries ({name}, "
            f"K-dims {list(ts_Ks)}) need FFBS, which is not ported to "
            f"alan_tpu_torch yet (ROADMAP queue 1 item 4)")

    # condition every factor on the indices drawn so far
    lps = [_index_all(lp, indices) for lp in lps]

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


def _index_all(lp, indices):
    if getattr(lp, "__lazy_dt__", False):
        # a lazy factored log-prob: the replay indexes into the factor, so
        # the dense form is needed here
        lp = lp.materialize()
    for dim in [d for d in dims_of(lp) if d in indices]:
        lp = dt_index(lp, dim, indices[dim])
    return lp
