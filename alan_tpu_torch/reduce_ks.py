"""The K-contraction engine (counterpart of the non-timeseries part of
``alan_tpu/reduce_ks.py``).

Summing the K^n combinations of per-latent particles factorises into a
tensor-network contraction over the named K-dims.  The contraction is
planned once per program structure by the native planner
(``ops/pathopt.py``) and each path step runs as a fused
``logsumexp(sum of factors)`` over that step's K-dims.  A step that holds
the lazy low-rank factor goes through ``LowRankDT.contract`` (the fused
kernel on CUDA); a pairwise step with a large contracted dim becomes a
log-space batched matmul.
"""
from __future__ import annotations

import math

import torch

from .dims import DT, as_dt, dims_of, logsumexp_dims, unify_dims, check_unique_dims


def _matmul_min_k(device: torch.device) -> int:
    """Contracted-dim size above which a pairwise step becomes a log-space
    matmul.  ``alan_tpu`` keys this on its backend (``reduce_ks.py:41-52``):
    8 on a TPU, where the matmul unit pays, and never (2^30) on the CPU,
    where the broadcast path is faster.  The port takes the TPU branch for
    CUDA tensors and the broadcast branch for CPU tensors, so its CPU runs
    contract exactly as ``alan_tpu``'s CPU runs do."""
    return 8 if device.type == "cuda" else 1 << 30


#: minimum size of EACH free side (m, n) for the matmul reformulation
_MATMUL_MIN_MN = 8
#: minimum per-batch matrix size m*k for a matvec-shaped step to still
#: take the matmul route
_MATVEC_MIN_MK = 65536


def logsumexp_sum(Ks_to_sum, *lps) -> DT:
    """One contraction step: logsumexp over ``Ks_to_sum`` of the sum of
    factors."""
    lazy_idx = [i for i, lp in enumerate(lps) if getattr(lp, "__lazy_dt__", False)]
    if lazy_idx:
        # lazy factored log-prob (ops/lowrank.LowRankDT): fuse the cross-K
        # product into the contraction so it is never materialised; fall
        # back to the dense form when the step doesn't fit the fused shape
        if len(lazy_idx) == 1:
            lz = lps[lazy_idx[0]]
            present = set().union(*[set(dims_of(lp)) for lp in lps])
            out = lz.contract(tuple(k for k in Ks_to_sum if k in present),
                              [lp for i, lp in enumerate(lps) if i != lazy_idx[0]])
            if out is not None:
                return out
        lps = tuple(lp.materialize() if getattr(lp, "__lazy_dt__", False) else lp
                    for lp in lps)
    if len(lps) == 2:
        a, b = (as_dt(lp) for lp in lps)
        shared = [k for k in Ks_to_sum if k in a.dims and k in b.dims]
        k_size = math.prod(a.dim_size(k) for k in shared) if shared else 0
        set_ks = set(Ks_to_sum)
        m_size = math.prod([a.dim_size(d) for d in a.dims
                            if d not in b.dims and d not in set_ks] or [1])
        n_size = math.prod([b.dim_size(d) for d in b.dims
                            if d not in a.dims and d not in set_ks] or [1])
        # the matmul pays for a real [m,k]@[k,n] product, or for a matvec
        # whose per-batch matrix m*k is large (alan_tpu reduce_ks.py:121-139)
        viable = (min(m_size, n_size) >= _MATMUL_MIN_MN
                  or max(m_size, n_size) * k_size >= _MATVEC_MIN_MK)
        if k_size >= _matmul_min_k(a.data.device) and viable:
            from .ops.contraction import pairwise_logsumexp_contract
            return pairwise_logsumexp_contract(a, b, tuple(Ks_to_sum))
    total = lps[0]
    for lp in lps[1:]:
        total = total + lp
    return logsumexp_dims(total, tuple(Ks_to_sum), ignore_extra_dims=True)


def _plan(lps, Ks_to_sum):
    """Contraction path over the factor shapes (native planner, memoised)."""
    from .ops.pathopt import plan_path
    all_dims = unify_dims(lps)
    factor_dims = []
    sizes = {}
    for lp in lps:
        lp = as_dt(lp)
        assert lp.pos_ndim == 0, "contraction factors must have no positional axes"
        factor_dims.append(lp.dims)
        sizes.update(lp.dimsizes())
    out_dims = tuple(d for d in all_dims if d not in set(Ks_to_sum))
    return plan_path(tuple(factor_dims), tuple(sorted(sizes.items())), out_dims)


def collect_lps(lps, Ks_to_sum):
    """Execute the contraction; also return, per step, the factor lists and
    the K-dims eliminated there."""
    check_unique_dims(tuple(Ks_to_sum))
    lps = [as_dt(lp) for lp in lps]
    set_Ks = set(Ks_to_sum)

    path = [(0,)] if len(lps) == 1 else _plan(lps, Ks_to_sum)

    all_reduced_lps = [[*lps]]
    Ks_per_step = []
    for lp_idxs in path:
        lps_to_reduce = tuple(lps[i] for i in lp_idxs)
        lps = [lps[i] for i in range(len(lps)) if i not in lp_idxs]

        # eliminate the Ks that appear only in this step's factors
        remaining_dims = set(unify_dims(lps))
        step_Ks = tuple(set_Ks.difference(remaining_dims)
                        .intersection(unify_dims(lps_to_reduce)))
        Ks_per_step.append(step_Ks)

        lps.append(logsumexp_sum(step_Ks, *lps_to_reduce))
        all_reduced_lps.append([*lps])

    all_reduced_lps = all_reduced_lps[:-1]
    assert len(lps) == 1
    result = lps[0]

    keep = [i for i, Ks in enumerate(Ks_per_step) if Ks != ()]
    all_reduced_lps = [all_reduced_lps[i] for i in keep]
    Ks_per_step = [Ks_per_step[i] for i in keep]
    return result, all_reduced_lps, Ks_per_step


def reduce_Ks(lps, Ks_to_sum) -> DT:
    """Sum over ``Ks_to_sum``, returning a single factor."""
    result, _, _ = collect_lps(lps, Ks_to_sum)
    return result
