"""The log P/Q evaluator (counterpart of ``alan_tpu/logpq.py``).

A recursive walk over the (P, Q) plate trees gathers per-group log-factors
``log P - reduce_logQ(log Q) - log K`` (each carrying its K-dims and plate
dims), contracts the K-dims with the planned log-space engine
(``reduce_ks.py``), sums plates, and chains timeseries factors over their
plate's dim T with log-space matmuls (``ops/logmmexp.py``; T-sharded under
a ``MeshPlan`` that maps T to a mesh axis, ``parallel/seq.py``).

The computation strategy (``split.py``) chunks one plate: the chunks run
one after another, a Python loop (``alan_tpu`` runs equal chunks through
``lax.scan`` to keep XLA's program small; a CUDA graph unrolls the loop
anyway), each under ``torch.utils.checkpoint`` where a gradient is wanted,
so that the backward pass holds one chunk at a time; ``checkpoint`` runs
the outermost plate body under it and the plates inside plainly, so that
the backward pass runs the forward once more, not once a level.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.utils.checkpoint

from .dims import DT, as_dt, bind, reshape, sum_dims
from .ir.plate import Plate, update_scope
from .ir.dist import Dist, datagroup
from .ir.data import Data
from .ir.timeseries import Timeseries
from .ops.logmmexp import chain_logmmexp
from .reduce_ks import factor_components, reduce_Ks
from .split import checkpoint, no_checkpoint
from .utils import tree_values


def logPQ_plate(name: Optional[str], P: Plate, Q: Plate, sample: dict,
                inputs_params: dict, data: dict, extra_log_factors: dict,
                scope: dict, active_platedims: list, all_platedims: dict,
                groupvarname2Kdim: dict, varname2groupvarname: dict,
                sampler, computation_strategy):
    """Evaluate a plate, in the chunks of a ``Split`` along it (each chunk's
    plate sum added to the running accumulator), each chunk under
    ``torch.utils.checkpoint`` where a gradient is wanted and the plate is
    split or the strategy is ``checkpoint`` (whose plates inside then run
    plainly): the tensors a chunk saves for
    the backward pass (the fused log-matmul's kept state, 20.5 GB a region
    of covid at K = 300) would otherwise all live until the backward, and
    the split would bound nothing."""
    siedas = computation_strategy.split_args(
        name=name, sample=sample, inputs_params=inputs_params,
        extra_log_factors=extra_log_factors, data=data,
        all_platedims=all_platedims)
    if len(siedas) > 1 and any(isinstance(v, Timeseries)
                               for v in P.flat_prog.values()):
        # the T dim is a Markov chain: chunking it changes the lagged-sample
        # alignment
        raise ValueError(
            f"You can't Split along plate '{name}' because it contains a "
            f"Timeseries: splitting the T dimension is unsupported")
    assert isinstance(P, Plate) and isinstance(Q, Plate)

    def body(sample, inputs_params, data, extra_log_factors, all_platedims,
             prev_lpq):
        return _plate_body(
            name=name, P=P, Q=Q, sample=sample, inputs_params=inputs_params,
            data=data, extra_log_factors=extra_log_factors, scope=scope,
            active_platedims=active_platedims, all_platedims=all_platedims,
            groupvarname2Kdim=groupvarname2Kdim,
            varname2groupvarname=varname2groupvarname, sampler=sampler,
            computation_strategy=computation_strategy, prev_lpq=prev_lpq)

    remat = ((computation_strategy is checkpoint or len(siedas) > 1)
             and torch.is_grad_enabled())
    if remat and computation_strategy is checkpoint:
        # The plates inside run plainly: a checkpoint nested in a checkpoint
        # would run the inner forward once more in the backward per level.
        computation_strategy = no_checkpoint
    lpq = None
    for s in siedas:
        args = (s["sample"], s["inputs_params"], s["data"],
                s["extra_log_factors"], s["all_platedims"], lpq)
        if remat:
            # The forward keeps nothing for the backward pass, which runs the
            # body again.  A plate body draws no random numbers, so there is
            # no RNG state to replay: preserve_rng_state=False, which also
            # keeps the checkpoint from reading and stashing the generators'
            # states, a host read that a CUDA-graph capture cannot record.
            lpq = torch.utils.checkpoint.checkpoint(
                body, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            lpq = body(*args)
    return lpq


def _plate_body(*, name, P, Q, sample, inputs_params, data, extra_log_factors,
                scope, active_platedims, all_platedims, groupvarname2Kdim,
                varname2groupvarname, sampler, computation_strategy, prev_lpq):
    """One chunk of a plate: its factors contracted over their K-dims and
    summed over the plate, plus ``prev_lpq``, the sum of the chunks
    before it."""
    if name is not None:
        active_platedims = [*active_platedims, name]

    scope = update_scope(scope, inputs_params)
    scope = update_scope(scope, sample)

    lps, all_Ks, K_currs, K_inits = lp_getter(
        P=P, Q=Q, sample=sample, inputs_params=inputs_params, data=data,
        extra_log_factors=extra_log_factors, scope=scope,
        active_platedims=active_platedims, all_platedims=all_platedims,
        groupvarname2Kdim=groupvarname2Kdim,
        varname2groupvarname=varname2groupvarname, sampler=sampler,
        computation_strategy=computation_strategy)
    assert len(K_currs) == len(K_inits)

    if name is not None and K_inits:
        assert prev_lpq is None
        return _reduce_timeseries_plate(lps, all_Ks, K_currs, K_inits, name,
                                        all_platedims)

    lp = reduce_Ks(lps, all_Ks)
    if name is not None:
        lp = sum_dims(lp, (name,), ignore_extra_dims=True)
        if prev_lpq is not None:
            assert set(lp.dims) == set(prev_lpq.dims)
            lp = lp + prev_lpq
    return lp


def _reduce_timeseries_plate(lps, all_Ks, K_currs, K_inits, name,
                             all_platedims):
    """Contract a timeseries plate's factors.

    The factors are partitioned into connected components linked by shared
    eliminated K-dims (``reduce_ks.factor_components``): independent chains
    contract separately and the per-component results add in log-space.
    Components that hold timeseries groups chain the joint
    ``[T, prod Ki, prod K]`` operator over T.  ``ALAN_TPU_TS_JOINT=1`` (read
    at every call) forces one component, the joint chain of every group,
    for equality tests."""
    T_size = all_platedims[name]
    if os.environ.get("ALAN_TPU_TS_JOINT") == "1":
        comps = [(list(range(len(lps))), set(all_Ks) | set(K_currs))]
    else:
        comps = factor_components([tuple(as_dt(lp).dims) for lp in lps],
                                  set(all_Ks) | set(K_currs))

    total = None
    for fidxs, cdims in comps:
        clps = [lps[i] for i in fidxs]
        c_nonts = [k for k in all_Ks if k in cdims]
        c_groups = [g for g, kc in enumerate(K_currs) if kc in cdims]
        if c_nonts:
            r = reduce_Ks(clps, c_nonts)
        else:
            r = clps[0]
            for x in clps[1:]:
                r = r + x
        if getattr(r, "__lazy_dt__", False):
            r = r.materialize()
        if c_groups:
            r = _chain_ts(r, name, [K_inits[g] for g in c_groups],
                          [K_currs[g] for g in c_groups])
        elif name in r.dims:
            r = sum_dims(r, (name,))
        else:
            # a factor with no plate dim is broadcast over T: summed T times
            r = r * float(T_size)
        total = r if total is None else total + r
    return total


def _chain_ts(lp, name, K_inits, K_currs):
    """Chain one component's timeseries groups jointly: flatten the Kinit
    dims into one axis and the Kcurr dims into another, chain the
    ``[T, prod Ki, prod K]`` operator over T, logsumexp the final state, and
    unflatten back to the separate Kinit dims."""
    o = lp.order(name, *K_inits, *K_currs)      # (*hi, T, Ki..., K...)
    n = len(K_inits)
    nrem = len(o.dims)
    shp = o.data.shape
    ki_sizes = tuple(shp[nrem + 1: nrem + 1 + n])
    k_sizes = tuple(shp[nrem + 1 + n:])
    joint = reshape(o.data, tuple(shp[:nrem]) + (shp[nrem], math.prod(ki_sizes),
                                                 math.prod(k_sizes)))
    joint = _constrain_chain_operand(joint, o.dims, name)
    chained = _chain(joint, name)               # (*hi, prod Ki, prod K)
    maxv = torch.amax(chained, dim=-1).detach()
    summed = torch.log(torch.sum(torch.exp(chained - maxv[..., None]), dim=-1))
    out = reshape(summed + maxv, tuple(shp[:nrem]) + ki_sizes)
    return bind(DT(out, o.dims), *K_inits)


def _constrain_chain_operand(joint, hi_dims, platename):
    """Under a MeshPlan, lay the chain operator out before the log-matmul
    tree (``alan_tpu``'s ``logpq.py:293-321``): the plate (hi) dims keep
    their planned mesh axes, the T dim its sequence axis if T is planned,
    and the Ki / K axes are replicated, gathered once here instead of at
    every level of the tree."""
    from .parallel.mesh import active_plan
    plan = active_plan()
    if plan is None:
        return joint
    pl = plan.placements((*hi_dims, platename), tuple(joint.shape), warn=False)
    return plan.shard(joint, pl)


def _chain(ms, platename):
    """Chain-contract ``ms[..., T, Ki, K]`` over T: under a MeshPlan that
    maps the timeseries plate to a mesh axis, the T-sharded chain
    (``parallel/seq.py``, counted as the single-rank chain); otherwise
    ``chain_logmmexp``."""
    from .parallel.mesh import active_plan
    plan = active_plan()
    if plan is not None:
        axis = plan._axis_for(platename)
        if axis is not None:
            T = ms.shape[-3]
            n = plan.axis_size(axis)
            if T % n == 0:
                from .ops.logmmexp import count_chain
                from .parallel.seq import chain_logmmexp_sharded
                count_chain(ms.shape)
                return chain_logmmexp_sharded(ms, plan.mesh, axis)
            plan._undividable(platename, T, axis, n)
    return chain_logmmexp(ms)


def logPQ_gdt(*, name, P, Q, sample, data, scope, active_platedims,
              groupvarname2Kdim, sampler):
    """Per-group factor: ``sum logP - reduce_logQ(sum logQ) - log K``; for a
    Data variable, ``log P(data)``.  Returns ``(lp, non-timeseries K-dims,
    timeseries K-dims, Kinit dims)``."""
    assert set(P.keys()) == set(Q.keys())

    if datagroup(Q):
        assert len(Q) == 1
        k = next(iter(Q))
        assert isinstance(Q[k], Data) and sample[k] is None
        return P[k].log_prob(data[k], scope), (), (), ()

    Kdim = groupvarname2Kdim[name]
    T_dim = active_platedims[-1] if active_platedims else None
    total_logP = 0.0
    total_logQ = 0.0
    Kinits = []
    K = None
    for k in P:
        dist_P, dist_Q, sample_k = P[k], Q[k], sample[k]
        assert isinstance(dist_P, (Dist, Timeseries))
        assert isinstance(dist_Q, (Dist, Timeseries))
        assert sample_k is not None and data[k] is None
        K = as_dt(sample_k).dim_size(Kdim)
        lp, Kinit_p = _log_prob(dist_P, sample_k, scope, T_dim, Kdim)
        lq, Kinit_q = _log_prob(dist_Q, sample_k, scope, T_dim, Kdim)
        if Kinit_q is not None:
            assert Kinit_p == Kinit_q
        if Kinit_p is not None:
            Kinits.append(Kinit_p)
        total_logP = total_logP + lp
        total_logQ = total_logQ + lq

    total_logQ = sampler.reduce_logQ(total_logQ, active_platedims, Kdim)
    lp = total_logP - total_logQ - math.log(K)
    if Kinits:
        assert all(ki == Kinits[0] for ki in Kinits)
        return lp, (), (Kdim,), (Kinits[0],)
    return lp, (Kdim,), (), ()


def _log_prob(dist, sample, scope, T_dim, K_dim):
    """(lp, Kinit dim or None) of a Dist or a Timeseries."""
    if isinstance(dist, Timeseries):
        return dist.log_prob(sample, scope, T_dim, K_dim)
    return dist.log_prob(sample, scope), None


def lp_getter(*, P, Q, sample, inputs_params, data, extra_log_factors, scope,
              active_platedims, all_platedims, groupvarname2Kdim,
              varname2groupvarname, sampler, computation_strategy):
    """Traverse Q (by P's structure) collecting per-child log factors, the
    non-timeseries K-dims to sum at this level, and the timeseries K-dims
    with their Kinit dims."""
    assert set(P.flat_prog.keys()) == set(Q.flat_prog.keys())

    lps = list(tree_values(extra_log_factors).values())
    Knon_timeseries, Ktimeseries, Kinits = [], [], []
    for childname, childQ in Q.grouped_prog.items():
        if isinstance(childQ, dict):
            lp, Knt, Kt, Ki = logPQ_gdt(
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
            Knt, Kt, Ki = (), (), ()
        lps.append(lp)
        Knon_timeseries.extend(Knt)
        Ktimeseries.extend(Kt)
        Kinits.extend(Ki)
    return lps, Knon_timeseries, Ktimeseries, Kinits
