"""The log P/Q evaluator (counterpart of ``alan_tpu/logpq.py`` without its
timeseries, chunked-scan and rematerialisation branches).

A recursive walk over the (P, Q) plate trees gathers per-group log-factors
``log P - reduce_logQ(log Q) - log K`` (each carrying its K-dims and plate
dims), contracts the K-dims with the planned log-space engine
(``reduce_ks.py``) and sums plates.
"""
from __future__ import annotations

import math
from typing import Optional

from .dims import as_dt, sum_dims
from .ir.plate import Plate, update_scope
from .ir.dist import Dist, datagroup
from .ir.data import Data
from .reduce_ks import reduce_Ks
from .utils import tree_values


def logPQ_plate(name: Optional[str], P: Plate, Q: Plate, sample: dict,
                inputs_params: dict, data: dict, extra_log_factors: dict,
                scope: dict, active_platedims: list, all_platedims: dict,
                groupvarname2Kdim: dict, varname2groupvarname: dict,
                sampler, computation_strategy):
    """Evaluate a plate (one chunk: the ported strategy does not split)."""
    siedas = computation_strategy.split_args(
        name=name, sample=sample, inputs_params=inputs_params,
        extra_log_factors=extra_log_factors, data=data,
        all_platedims=all_platedims)
    assert len(siedas) == 1
    s = siedas[0]
    assert isinstance(P, Plate) and isinstance(Q, Plate)

    if name is not None:
        active_platedims = [*active_platedims, name]

    scope = update_scope(scope, s["inputs_params"])
    scope = update_scope(scope, s["sample"])

    lps, all_Ks = lp_getter(
        P=P, Q=Q, sample=s["sample"], inputs_params=s["inputs_params"],
        data=s["data"], extra_log_factors=s["extra_log_factors"], scope=scope,
        active_platedims=active_platedims, all_platedims=s["all_platedims"],
        groupvarname2Kdim=groupvarname2Kdim,
        varname2groupvarname=varname2groupvarname, sampler=sampler,
        computation_strategy=computation_strategy)

    lp = reduce_Ks(lps, all_Ks)
    if name is not None:
        lp = sum_dims(lp, (name,), ignore_extra_dims=True)
    return lp


def logPQ_gdt(*, name, P, Q, sample, data, scope, active_platedims,
              groupvarname2Kdim, sampler):
    """Per-group factor: ``sum logP - reduce_logQ(sum logQ) - log K``; for a
    Data variable, ``log P(data)``."""
    assert set(P.keys()) == set(Q.keys())

    if datagroup(Q):
        assert len(Q) == 1
        k = next(iter(Q))
        assert isinstance(Q[k], Data) and sample[k] is None
        return P[k].log_prob(data[k], scope), ()

    Kdim = groupvarname2Kdim[name]
    total_logP = 0.0
    total_logQ = 0.0
    K = None
    for k in P:
        dist_P, dist_Q, sample_k = P[k], Q[k], sample[k]
        assert isinstance(dist_P, Dist) and isinstance(dist_Q, Dist)
        assert sample_k is not None and data[k] is None
        K = as_dt(sample_k).dim_size(Kdim)
        total_logP = total_logP + dist_P.log_prob(sample_k, scope)
        total_logQ = total_logQ + dist_Q.log_prob(sample_k, scope)

    total_logQ = sampler.reduce_logQ(total_logQ, active_platedims, Kdim)
    return total_logP - total_logQ - math.log(K), (Kdim,)


def lp_getter(*, P, Q, sample, inputs_params, data, extra_log_factors, scope,
              active_platedims, all_platedims, groupvarname2Kdim,
              varname2groupvarname, sampler, computation_strategy):
    """Traverse Q (by P's structure) collecting per-child log factors and
    the K-dims to sum at this level."""
    assert set(P.flat_prog.keys()) == set(Q.flat_prog.keys())

    lps = list(tree_values(extra_log_factors).values())
    all_Ks = []
    for childname, childQ in Q.grouped_prog.items():
        if isinstance(childQ, dict):
            lp, Ks = logPQ_gdt(
                name=childname, P={vn: P.flat_prog[vn] for vn in childQ},
                Q=childQ, sample=Q.grouped_get(sample, childname),
                data=Q.grouped_get(data, childname), scope=scope,
                active_platedims=active_platedims,
                groupvarname2Kdim=groupvarname2Kdim, sampler=sampler)
        else:
            childP = P.flat_prog[childname]
            assert isinstance(childQ, Plate) and isinstance(childP, Plate)
            lp = logPQ_plate(
                name=childname, P=childP, Q=childQ,
                sample=Q.grouped_get(sample, childname),
                inputs_params=inputs_params.get(childname) or {},
                data=Q.grouped_get(data, childname),
                extra_log_factors=extra_log_factors.get(childname) or {},
                scope=scope, active_platedims=active_platedims,
                all_platedims=all_platedims,
                groupvarname2Kdim=groupvarname2Kdim,
                varname2groupvarname=varname2groupvarname, sampler=sampler,
                computation_strategy=computation_strategy)
            Ks = ()
        lps.append(lp)
        all_Ks.extend(Ks)
    return lps, all_Ks
