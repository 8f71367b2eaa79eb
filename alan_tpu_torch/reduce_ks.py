"""The K-contraction engine and its reverse replay (counterpart of
``alan_tpu/reduce_ks.py`` without FFBS, the timeseries draws).

Summing the K^n combinations of per-latent particles factorises into a
tensor-network contraction over the named K-dims.  The contraction is
planned once per program structure by the native planner
(``ops/pathopt.py``) and each path step runs as a fused
``logsumexp(sum of factors)`` over that step's K-dims.  A step that holds
the lazy low-rank factor goes through ``LowRankDT.contract`` (the fused
kernel on CUDA); a pairwise step with a large contracted dim becomes a
log-space batched matmul.

The matmul route reads ``alan_tpu``'s knobs with its defaults:
``ALAN_TPU_NO_MATMUL_CONTRACT``, ``ALAN_TPU_MATMUL_MIN_K``,
``ALAN_TPU_MATMUL_MIN_MN`` and ``ALAN_TPU_MATVEC_MIN_MK``.  ``alan_tpu``
reads the first two once, when it is imported; the port reads all four at
every call, which takes the same routes under a fixed environment and lets
a test or a cross-check set them for one call.
"""
from __future__ import annotations

import math
import os

import torch

from .dims import (DT, as_dt, dims_of, dt_index, logsumexp_dims, unify_dims,
                   check_unique_dims)


def _use_matmul_contract() -> bool:
    """``ALAN_TPU_NO_MATMUL_CONTRACT=1`` keeps every step on the broadcast
    route."""
    return os.environ.get("ALAN_TPU_NO_MATMUL_CONTRACT") != "1"


def _matmul_min_k(device: torch.device) -> int:
    """Contracted-dim size above which a pairwise step becomes a log-space
    matmul: ``ALAN_TPU_MATMUL_MIN_K`` where it is set.  Unset, ``alan_tpu``
    keys it on its backend (``reduce_ks.py:41-52``): 8 on a TPU, where the
    matmul unit pays, and never (2^30) on the CPU, where the broadcast path
    is faster.  The port takes the TPU branch for CUDA tensors and the
    broadcast branch for CPU tensors, so its CPU runs contract exactly as
    ``alan_tpu``'s CPU runs do."""
    env = os.environ.get("ALAN_TPU_MATMUL_MIN_K")
    if env is not None:
        return int(env)
    return 8 if device.type == "cuda" else 1 << 30


def _matmul_min_mn() -> int:
    """Minimum size of EACH free side (m, n) for the matmul reformulation."""
    return int(os.environ.get("ALAN_TPU_MATMUL_MIN_MN", "8"))


def _matvec_min_mk() -> int:
    """Minimum per-batch matrix size m*k for a matvec-shaped step to still
    take the matmul route."""
    return int(os.environ.get("ALAN_TPU_MATVEC_MIN_MK", "65536"))


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
    if len(lps) == 2 and _use_matmul_contract():
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
        viable = (min(m_size, n_size) >= _matmul_min_mn()
                  or max(m_size, n_size) * k_size >= _matvec_min_mk())
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


def gumbel(shape, like: torch.Tensor, keygen, noise=None) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in ``like``'s dtype and device:
    the next tensor of the iterator ``noise`` where one is given, else
    ``-log(-log(U))`` with ``U`` uniform from the traversal's generator,
    clamped to the smallest normal float as ``jax.random.gumbel`` clamps
    it."""
    if noise is not None:
        try:
            g = next(noise)
        except StopIteration:
            raise ValueError("the injected Gumbel noise ran out before the "
                             "draws did") from None
        g = torch.as_tensor(g, dtype=like.dtype, device=like.device)
        if tuple(g.shape) != tuple(shape):
            raise ValueError(f"injected Gumbel noise of shape {tuple(g.shape)}, "
                             f"the draw's is {tuple(shape)}")
        return g
    gen = keygen()
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=like.dtype)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(like.dtype).tiny)))


def sample_Ks(lps, Ks_to_sum, N_dim: str, num_samples: int, keygen,
              indices: dict | None = None, noise=None) -> dict:
    """Draw ``num_samples`` joint posterior K-indices by replaying the
    contraction in reverse.  Returns a dict K-dim name -> integer DT carrying
    ``N_dim`` (plus plate dims); ``indices`` carries the indices already
    drawn for other K-dims.

    Each step draws by Gumbel-max: ``argmax(g + logits)`` over the step's
    joint K-index, ``g`` of shape ``(N, *batch, K1*K2...)`` where the
    conditional log-weights lack ``N_dim`` and ``(*batch, K1*K2...)`` where
    they carry it, which is ``jax.random.categorical``'s shape.  ``noise``,
    an iterator of such tensors in draw order, replaces the generator's."""
    check_unique_dims(tuple(Ks_to_sum))
    assert set(unify_dims(lps)).issuperset(Ks_to_sum)

    _, lps_for_sampling, Ks_per_step = collect_lps(lps, Ks_to_sum)

    indices = dict(indices or {})
    for step_lps, kdims in zip(lps_for_sampling[::-1], Ks_per_step[::-1]):
        # the replay indexes into the factors: a lazy factored log-prob
        # (ops/lowrank.LowRankDT) must be dense here
        step_lps = [lp.materialize() if getattr(lp, "__lazy_dt__", False)
                    else lp for lp in step_lps]
        lp = step_lps[0]
        for x in step_lps[1:]:
            lp = lp + x

        # condition on the K-dims drawn already
        for dim in [d for d in dims_of(lp) if d in indices]:
            lp = dt_index(lp, dim, indices[dim])

        o = lp.order(*kdims)                       # dims rest, pos (k1, k2, ...)
        flat = o.data.reshape(tuple(o.data.shape[:len(o.dims)]) + (-1,))
        if N_dim in o.dims:
            # one draw per (N, plates...) cell
            idx_dims = o.dims
        else:
            flat = flat.expand((num_samples,) + tuple(flat.shape))
            idx_dims = (N_dim,) + o.dims
        idx = torch.argmax(gumbel(flat.shape, flat, keygen, noise) + flat, dim=-1)

        sizes = tuple(lp.dim_size(k) for k in kdims)
        for kdim, u in zip(kdims, torch.unravel_index(idx, sizes)):
            indices[kdim] = DT(u, idx_dims)
    return indices


def factor_components(factor_dims, elim):
    """Partition factors into connected components linked by shared dims in
    ``elim`` (union-find).  Returns a list of ``(factor_idxs, comp_dims)``
    with ``factor_idxs`` sorted and components ordered by smallest factor
    index; ``comp_dims`` is the set of elim dims present in the component.

    Two factors must be reduced together iff they share an eliminated dim
    (directly or transitively): eliminations over disjoint dim sets commute,
    so each component contracts independently and the results add in
    log-space.  This is what lets n independent timeseries in one plate cost
    n * O(T K^2) instead of the joint O(T K^2n) chain.
    """
    elim = set(elim)
    parent = list(range(len(factor_dims)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    dim2first = {}
    for i, ds in enumerate(factor_dims):
        for d in ds:
            if d not in elim:
                continue
            if d in dim2first:
                ri, rj = find(i), find(dim2first[d])
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
            else:
                dim2first[d] = i

    comps = {}
    for i in range(len(factor_dims)):
        comps.setdefault(find(i), []).append(i)
    return [(idxs, set().union(*(set(factor_dims[i]) & elim for i in idxs)))
            for _, idxs in sorted(comps.items())]
