"""The K-contraction engine, its reverse replay and forward-filtering
backward-sampling (FFBS) of timeseries particle chains (counterpart of
``alan_tpu/reduce_ks.py``).

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

from . import perf
from .dims import (DT, as_dt, bind, concat_dim, dims_of, dt_index, expand_to,
                   logsumexp_dims, slice_dim, unify_dims, check_unique_dims)


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
    if perf.counting_active():
        # broadcast-add route: (n-1) adds over the joint space, then a
        # ~4-op/element logsumexp (max/sub/exp/add) over the reduced dims
        perf.count_flops(elementwise=(len(lps) + 3.0) * as_dt(total).data.numel())
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


def _categorical(logits, keygen, noise=None, shape=None) -> torch.Tensor:
    """One Gumbel-max draw over the last axis of ``logits``,
    ``argmax(g + logits)``: ``jax.random.categorical(key, logits, axis=-1,
    shape=shape)``, the logits broadcast to ``shape`` where it is given."""
    if shape is not None:
        logits = logits.expand(tuple(shape) + (logits.shape[-1],))
    return torch.argmax(gumbel(logits.shape, logits, keygen, noise) + logits, dim=-1)


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
            idx = _categorical(flat, keygen, noise)
            idx_dims = o.dims
        else:
            idx = _categorical(flat, keygen, noise,
                               (num_samples,) + tuple(flat.shape[:-1]))
            idx_dims = (N_dim,) + o.dims

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


# ---- FFBS: posterior indices of timeseries K-dims ---------------------------

def _index_dim_int(x, dim: str, i: int) -> DT:
    """Pick index ``i`` along a named dim (drops the dim)."""
    o = as_dt(x).order(dim)
    return DT(o.data.select(len(o.dims), i), o.dims)


def _categorical_over(lp, kdim, N_dim, num_samples, keygen, noise=None) -> DT:
    """One categorical draw over ``kdim`` per remaining cell (adds
    ``N_dim`` if absent)."""
    o = lp.order(kdim)
    logits = torch.movedim(o.data, len(o.dims), -1)     # (*rest, K)
    if N_dim in o.dims:
        return DT(_categorical(logits, keygen, noise), o.dims)
    return DT(_categorical(logits, keygen, noise,
                           (num_samples,) + tuple(logits.shape[:-1])),
              (N_dim,) + o.dims)


def _ffbs_joint_max() -> int:
    """Largest joint chain-state size prod K for which a coupled component of
    timeseries K-groups is smoothed exactly over the flattened product
    space (``ALAN_TPU_FFBS_JOINT_MAX``, read at every call); beyond it the
    linear-cost conditional pass takes over."""
    return int(os.environ.get("ALAN_TPU_FFBS_JOINT_MAX", "4096"))


#: routing trace for tests: ("joint" | "conditional", (ts K-dims...)) per
#: component, reset at every sample_Ks_timeseries call
_ffbs_routes: list = []


def sample_Ks_timeseries(lps, ts_Ks, ts_init_Ks, N_dim, num_samples, T_dim,
                         indices, keygen, noise=None) -> dict:
    """Posterior indices of a plate's timeseries K-dims by forward filtering
    and backward sampling over the particle index chain.

    The plate's timeseries K-groups are partitioned into connected
    components of the factor graph (``factor_components``; a K-dim not yet
    drawn couples the factors that carry it, since FFBS marginalises it).
    Each component is smoothed exactly over its joint state (``_ffbs_joint``)
    when it holds one chain, when its joint state prod K is at most
    ``_ffbs_joint_max()`` or when two of its chains share an init K-dim;
    else group by group (``_ffbs_conditional``, approximate).  The draws
    take their Gumbel noise in ``alan_tpu``'s order: per component, the
    last step first, then the steps T-2 down to 0."""
    check_unique_dims(tuple(ts_Ks))
    assert len(ts_Ks) == len(ts_init_Ks) >= 1
    indices = dict(indices)
    set_init = set(ts_init_Ks)

    lps = [lp.materialize() if getattr(lp, "__lazy_dt__", False) else lp
           for lp in lps]
    elim = set(ts_Ks)
    for lp in lps:
        for d in dims_of(lp):
            if d.startswith("K_") and d not in indices and d not in set_init:
                elim.add(d)

    _ffbs_routes.clear()
    fdims = [tuple(dims_of(lp)) for lp in lps]
    for fidxs, cdims in factor_components(fdims, elim):
        c_ts = [k for k in ts_Ks if k in cdims]
        if not c_ts:
            continue  # a component without a chain: sample_Ks draws it later
        c_inits = [ts_init_Ks[ts_Ks.index(k)] for k in c_ts]
        clps = [lps[i] for i in fidxs]
        sizes = {}
        for lp in clps:
            sizes.update(as_dt(lp).dimsizes())
        joint = math.prod(sizes[k] for k in c_ts)
        shared_init = len(set(c_inits)) < len(c_inits)
        if len(c_ts) == 1 or joint <= _ffbs_joint_max() or shared_init:
            _ffbs_routes.append(("joint", tuple(c_ts)))
            route = _ffbs_joint
        else:
            _ffbs_routes.append(("conditional", tuple(c_ts)))
            route = _ffbs_conditional
        indices = route(clps, c_ts, c_inits, N_dim, num_samples, T_dim, indices,
                        keygen, noise)
    return indices


#: floats of the (..., i, j) sum that one chunk of ``_log_matvec`` holds
_MATVEC_CHUNK = 1 << 26


def _log_matvec(alpha, M_t):
    """``logsumexp_i alpha[..., i] + M_t[..., i, j]`` for ``alpha`` of shape
    ``(*extra, *batch, Ki)`` and ``M_t`` of ``(*batch, Ki, K)``, each column
    shifted by its own max over i (0 where that is not finite, so that a
    column of -inf gives -inf, not NaN).

    ``alan_tpu`` (``reduce_ks.py:484-494``) shifts alpha and M_t by their
    separate maxes and takes one matmul of the exponentials: where no
    single i carries both a large ``alpha_i`` and a large ``M_t[i, j]``,
    every product underflows and the column comes out -inf.  Covid's
    transitions (scale ~0.01, particles ~1 apart at Q's initial state) put
    the terms ~1e4 nats apart, so there alan_tpu's filter loses every
    state and each draw takes index 0.  The joint shift is exact; it reads
    the (..., i, j) sum once, in chunks over the extra dims of at most
    ``_MATVEC_CHUNK`` floats."""
    n_extra = alpha.dim() - (M_t.dim() - 1)
    lead = tuple(alpha.shape[:n_extra])
    a = alpha.reshape((-1,) + tuple(alpha.shape[n_extra:]))
    step = max(1, _MATVEC_CHUNK // M_t.numel())
    outs = []
    for i in range(0, a.shape[0], step):
        x = a[i:i + step].unsqueeze(-1) + M_t
        x_max = torch.amax(x, dim=-2, keepdim=True)
        x_max = torch.where(torch.isfinite(x_max), x_max, torch.zeros_like(x_max))
        outs.append(torch.log(torch.sum(torch.exp(x - x_max), dim=-2))
                    + x_max.squeeze(-2))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out.reshape(lead + tuple(out.shape[1:]))


def _ffbs_joint(sel, ts_Ks, ts_init_Ks, N_dim, num_samples, T_dim, indices,
                keygen, noise=None) -> dict:
    """Exact FFBS of one coupled component: the forward filter over the
    flattened product state space [T, prod Ki, prod K], backward ancestral
    sampling, and the joint index unravelled into per-group indices."""
    indices = dict(indices)
    set_ts, set_init = set(ts_Ks), set(ts_init_Ks)

    lp = sel[0]
    for x in sel[1:]:
        lp = lp + x
    for d in (T_dim, *ts_Ks, *ts_init_Ks):
        assert d in dims_of(lp), d
    for ki in ts_init_Ks:
        assert ki in indices

    # condition on the K-dims drawn already, but the inits, which enter
    # through alpha_0 (at t > 0 the init dim is the chain's own lagged
    # particle); these carry N, so M does too
    for dim in [d for d in dims_of(lp) if d in indices and d not in set_init]:
        lp = dt_index(lp, dim, indices[dim])
    # marginalise the plate's K-dims not drawn yet, as the ELBO does
    other_Ks = tuple(d for d in dims_of(lp) if d.startswith("K_")
                     and d not in set_ts and d not in set_init
                     and d not in indices)
    if other_Ks:
        lp = logsumexp_dims(lp, other_Ks, ignore_extra_dims=True)

    o = lp.order(T_dim, *ts_init_Ks, *ts_Ks)   # (*rest_M, T, Ki..., K...)
    rest_M = o.dims
    nrem, n = len(rest_M), len(ts_Ks)
    shp = tuple(o.data.shape)
    ki_sizes = shp[nrem + 1: nrem + 1 + n]
    k_sizes = shp[nrem + 1 + n:]
    M = o.data.reshape(shp[:nrem + 1] + (math.prod(ki_sizes), math.prod(k_sizes)))
    M = torch.movedim(M, nrem, 0)               # (T, *rest_M, prod Ki, prod K)
    T = M.shape[0]

    # the joint init index: the per-group init indices raveled row-major
    init_dt = None
    for sz, ki in zip(ki_sizes, ts_init_Ks):
        idx = as_dt(indices[ki])
        init_dt = idx if init_dt is None else init_dt * sz + idx
    if N_dim not in dims_of(init_dt):
        init_dt = init_dt + DT(torch.zeros((num_samples,), dtype=torch.int64,
                                           device=M.device), (N_dim,))

    # alpha's dims: (extra..., rest_M...), rest_M the suffix so that raw
    # tensors broadcast right-aligned against M's batch block
    a0 = dt_index(bind(DT(M[0], rest_M), "*Ki"), "*Ki", init_dt)
    extra = tuple(d for d in a0.dims if d not in rest_M)
    a0 = a0.with_dims_front(extra + tuple(rest_M))
    alphas = [a0.data]                          # each (*extra, *rest_M, prod K)
    for t in range(1, T):
        alphas.append(_log_matvec(alphas[-1], M[t]))

    # backward ancestral sampling: the last step, then T-2 down to 0
    k = _categorical(alphas[T - 1], keygen, noise)
    ks = [k]
    lead = (1,) * len(extra)
    for t in range(T - 2, -1, -1):
        M_next = M[t + 1].reshape(lead + tuple(M[t + 1].shape))
        sel_t = torch.take_along_dim(M_next, k[..., None, None], dim=-1)[..., 0]
        k = _categorical(alphas[t] + sel_t, keygen, noise)
        ks.append(k)
    ks = torch.stack(ks[::-1], 0)               # (T, *extra, *rest_M)

    for kdim, u in zip(ts_Ks, torch.unravel_index(ks, k_sizes)):
        indices[kdim] = DT(u, (T_dim,) + a0.dims)
    return indices


def _lagged_traj(traj, init_idx, T_dim) -> DT:
    """Shift a T-dimmed index trajectory one step along T: entry t is
    ``traj[t-1]``; entry 0 is the parent init-particle index."""
    traj, init_idx = as_dt(traj), as_dt(init_idx)
    o = traj.order(T_dim)                       # (*rest, T)
    rest = o.dims
    extra = [d for d in init_idx.dims if d not in rest]
    assert not extra, f"init index carries dims {extra} absent from trajectory"
    init = torch.broadcast_to(expand_to(init_idx, rest), o.data.shape[:-1])
    lag = torch.cat([init[..., None].to(o.data.dtype), o.data[..., :-1]], dim=-1)
    return DT(torch.movedim(lag, -1, 0), (T_dim,) + rest)


def _collapse_chain(f, kdj, kij, init_idx, T_dim) -> DT:
    """Collapse an undrawn timeseries chain's state dims from one factor, per
    time step (the conditional pass's approximation: the chain is
    integrated out as if independent across steps).  The lagged dim ``kij``
    at t=0 indexes the parent init particle, which is drawn already, so it
    is conditioned there rather than collapsed."""
    f = as_dt(f)
    if kdj in f.dims:
        f = logsumexp_dims(f, (kdj,), ignore_extra_dims=True)
    if kij is not None and kij in f.dims:
        if T_dim in f.dims and init_idx is not None:
            T = f.dim_size(T_dim)
            f0 = dt_index(slice_dim(f, T_dim, 0, 1), kij, init_idx)
            fr = logsumexp_dims(slice_dim(f, T_dim, 1, T), (kij,))
            for d in dims_of(f0):
                if d not in dims_of(fr):
                    fr = fr + DT(torch.zeros((f0.dim_size(d),), dtype=fr.dtype,
                                             device=fr.device), (d,))
            f = concat_dim([f0, fr], T_dim)
        elif init_idx is not None:
            # no T axis: the dim can only mean direct init dependence
            f = dt_index(f, kij, init_idx)
        else:
            f = logsumexp_dims(f, (kij,), ignore_extra_dims=True)
    return f


def _ffbs_conditional(clps, ts_Ks, ts_init_Ks, N_dim, num_samples, T_dim,
                      indices, keygen, noise=None) -> dict:
    """Linear-cost smoothing, group by group, of a coupled component whose
    joint chain state is too large.  Group i's chain is smoothed exactly
    after (a) conditioning every factor on the trajectories of the groups
    drawn before it (the lagged dim indexed by the shifted trajectory) and
    (b) collapsing the undrawn groups' chain dims per step, the
    approximation: their temporal consistency is ignored.  Undrawn
    non-timeseries K-dims are collapsed per factor."""
    indices = dict(indices)
    groups = list(zip(ts_Ks, ts_init_Ks))
    for kd, ki in groups:
        fs = []
        for f in clps:
            f = as_dt(f)
            for kdj, kij in groups:
                if kdj == kd:
                    continue
                if kdj in indices:
                    # drawn earlier: condition on its trajectory exactly
                    if kdj in f.dims:
                        f = dt_index(f, kdj, indices[kdj])
                    if kij in f.dims and kij != ki:
                        f = dt_index(f, kij, _lagged_traj(indices[kdj], indices[kij],
                                                          T_dim))
                elif kdj in f.dims or (kij in f.dims and kij != ki):
                    f = _collapse_chain(f, kdj, kij if kij != ki else None,
                                        indices.get(kij), T_dim)
            coll = tuple(d for d in dims_of(f) if d.startswith("K_")
                         and d not in indices and d != kd)
            if coll:
                f = logsumexp_dims(f, coll, ignore_extra_dims=True)
            fs.append(f)
        indices = _ffbs_joint(fs, [kd], [ki], N_dim, num_samples, T_dim, indices,
                              keygen, noise)
    return indices
