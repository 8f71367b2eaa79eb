"""Sequence (timeseries) parallelism: the T dim of the ``[T, K, K]``
log-transition chain sharded across ranks (counterpart of
``alan_tpu/parallel/seq.py``).

The contraction over T is a product of K x K log-space operators, an
associative reduce.  Sharded over a mesh axis it becomes a local chain per
shard (the port's ``chain_logmmexp``: the small-K chain kernels for K <=
100 on the card, the fused log-matmul for K >= 128), an exchange of the
per-shard boundary operators and their composition with ``logmmexp``.
"""
from __future__ import annotations

import torch

from ..ops.logmmexp import _chain_local, _logmmexp_local
from .. import perf

#: calls of ``chain_logmmexp_sharded`` (the route the engine takes under a
#: plan that shards a timeseries plate)
CALLS = 0


def _permute_raw(x, src_dst, group):
    """Send ``x`` from rank ``m`` of ``group`` to rank ``src_dst[m]``."""
    from torch.distributed import _functional_collectives as funcol
    from .collective_audit import labelled
    with labelled("collective-permute"):
        # an all-to-all with one non-empty split, whose sizes count
        # elements of dim 0: send the operator flat
        out = funcol.permute_tensor(x.reshape(-1).contiguous(), src_dst, group)
        return funcol.wait_tensor(out).reshape(x.shape)


class _Permute(torch.autograd.Function):
    """A point-to-point permute with a gradient: the backward sends each
    gradient back along the inverse permutation."""

    @staticmethod
    def forward(ctx, x, src_dst, group):
        ctx.inverse = [0] * len(src_dst)
        for s, d in enumerate(src_dst):
            ctx.inverse[d] = s
        ctx.group = group
        return _permute_raw(x, src_dst, group)

    @staticmethod
    def backward(ctx, g):
        return _permute_raw(g, ctx.inverse, ctx.group), None, None


def permute(x, src_dst, group):
    return _Permute.apply(x, list(src_dst), group)


class _FirstCopy(torch.autograd.Function):
    """The identity, whose backward passes the gradient on rank 0 of the
    axis only.  Every rank ends the exchange holding the same product,
    computed alike: the first copy's backward reaches every block through
    the exchange's own backward, and passing the others' too would count
    the gradient once a rank."""

    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def _local(method, n, i, group):
    def local_gather(ms_local):
        from torch.distributed import _functional_collectives as funcol
        prod = _chain_local(ms_local)                       # (..., K, K)
        gathered = funcol.all_gather_tensor_autograd(
            prod.unsqueeze(0).contiguous(), 0, group)       # (n, ..., K, K)
        return _chain_local(torch.movedim(gathered, 0, -3))

    def local_ring(ms_local):
        own = _chain_local(ms_local)
        K = own.shape[-1]
        eye = torch.eye(K, dtype=torch.bool, device=own.device)
        neutral = torch.zeros((), dtype=own.dtype, device=own.device).masked_fill(
            ~eye, float("-inf")).expand(own.shape)          # log-space identity
        # rotate each shard's own operator around the ring: at step s rank
        # i holds rank (i - s) mod n's.  Pieces from j < i arrive in
        # decreasing j and are prepended to the left block, pieces from
        # j > i also in decreasing j to the right block; the T-ordered
        # product is left . own . right
        perm = [(k + 1) % n for k in range(n)]
        rot, left, right = own, neutral, neutral
        for s in range(1, n):
            rot = permute(rot, perm, group)
            if (i - s) % n < i:
                left = _logmmexp_local(rot, left)
            else:
                right = _logmmexp_local(rot, right)
        return _logmmexp_local(_logmmexp_local(left, own), right)

    def local_butterfly(ms_local):
        # stage s composes adjacent blocks of 2^s shards, pairing them as
        # the balanced tree pairs them: with a power-of-two local T the
        # floats are the single-rank chain's
        own = _chain_local(ms_local)
        s = 1
        while s < n:
            other = permute(own, [k ^ s for k in range(n)], group)
            left, right = (other, own) if i & s else (own, other)
            own = _chain_local(torch.stack([left, right], dim=-3))
            s *= 2
        return own

    local = {"all_gather": local_gather, "ring": local_ring,
             "butterfly": local_butterfly}[method]
    return lambda ms_local: _FirstCopy.apply(local(ms_local), i == 0)


def chain_logmmexp_sharded(ms, mesh, axis: str, method: str = "auto"):
    """``ms[..., T, K, K] -> [..., K, K]`` with T sharded over the mesh axis
    ``axis``; T must divide the axis size.  ``ms`` is a ``DTensor`` (T
    sharded on ``axis``, other leading axes as they are; the K axes are
    gathered first) or a plain tensor, which every rank holds whole and
    whose result comes back whole.

    ``method``:
      * ``"butterfly"`` -- recursive doubling: log2(n) permutes, each
        exchanging one boundary operator per rank and composing adjacent
        blocks in T order, exactly as the balanced tree pairs them, so with
        a power-of-two local T the result is bitwise the single-rank
        chain's.  Needs n a power of two.
      * ``"all_gather"`` -- one all-gather of the n boundary operators and
        a small chain over them.
      * ``"ring"`` -- n - 1 permutes rotating each shard's operator around
        the ring, composed in T order as pieces arrive.
      * ``"auto"`` (default) -- butterfly when n is a power of two, else
        all_gather.

    The analytic FLOP hooks are paused inside: the engine counts the
    chain once, at its global shape (``ops.logmmexp.count_chain``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from .mesh import layout
    global CALLS
    names = mesh.mesh_dim_names
    m = names.index(axis)
    n = mesh.size(m)
    if method == "auto":
        method = "butterfly" if (n & (n - 1)) == 0 else "all_gather"
    if method == "butterfly" and n & (n - 1):
        raise ValueError(f"the butterfly needs a power-of-two axis, '{axis}' has {n}")
    T_dim = ms.dim() - 3
    if ms.shape[T_dim] % n:
        raise ValueError(f"T = {ms.shape[T_dim]} does not divide axis '{axis}' ({n})")
    plain = not isinstance(ms, DTensor)
    pl = [Replicate()] * mesh.ndim
    if not plain:
        for k, p in enumerate(ms.placements):
            if isinstance(p, Shard) and p.dim < T_dim and k != m:
                pl[k] = p
    pl[m] = Shard(T_dim)
    x = layout(ms, mesh, pl)
    out_pl = list(pl)
    out_pl[m] = Replicate()
    fn = _local(method, n, mesh.get_local_rank(m), mesh.get_group(m))
    CALLS += 1
    with perf.paused():
        out = local_map(fn, out_placements=(tuple(out_pl),), in_placements=(tuple(pl),),
                        device_mesh=mesh)(x)
    return out.full_tensor() if plain else out
