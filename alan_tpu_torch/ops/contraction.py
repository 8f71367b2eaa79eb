"""Log-space contraction steps as batched matmuls (counterpart of
``alan_tpu/ops/contraction.py``).

A reduce step of the K-contraction is ``logsumexp_{Ks}(A + B)``.  Evaluated
literally that is a broadcast add over the K-product space plus a
reduction, with an O(K^2 * batch) intermediate.  Reformulated as
``log( exp(A - Amax) @ exp(B - Bmax) ) + Amax + Bmax`` it becomes one
batched matrix product (``torch.matmul``, full f32) with the exp/log around
it.

Reduced dims private to one factor are logsumexp'd out first (the sum
factorises); the shared reduced dims form the matmul contraction; remaining
shared dims are batch.  The rank-1 shift ``Amax_i + Bmax_j`` upper-bounds
the joint max, so nothing overflows; accuracy degrades only when the bound
is loose by more than the f32 exp range (~87 nats).  Each step counts its
model FLOPs (``perf.count_flops``).
"""
from __future__ import annotations

import math

import torch

from .. import perf
from ..dims import DT, as_dt, logsumexp_dims, reshape, settled


def _finite_or_zero(t):
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def pairwise_logsumexp_contract(a, b, Ks) -> DT:
    """logsumexp over ``Ks`` of ``a + b`` via a log-space batched matmul."""
    a, b = as_dt(a), as_dt(b)
    Ks = [k for k in Ks if k in a.dims or k in b.dims]
    Ka = [k for k in Ks if k in a.dims and k not in b.dims]
    Kb = [k for k in Ks if k in b.dims and k not in a.dims]
    Kab = [k for k in Ks if k in a.dims and k in b.dims]

    if Ka:
        a = logsumexp_dims(a, tuple(Ka))
    if Kb:
        b = logsumexp_dims(b, tuple(Kb))
    if not Kab:
        return a + b

    batch = [d for d in a.dims if d in b.dims and d not in Kab]
    i_dims = [d for d in a.dims if d not in b.dims and d not in Kab]
    j_dims = [d for d in b.dims if d not in a.dims and d not in Kab]

    # The batch block is collapsed to one axis below; under a MeshPlan a
    # reshape that merges a sharded dim anywhere but majormost would gather
    # the operand whole (``alan_tpu``'s ``contraction.py:50-60``): put the
    # mesh-mapped dims first so the flat axis keeps their sharding.
    from ..parallel.mesh import active_plan
    plan = active_plan()
    if plan is not None and len(batch) > 1:
        batch.sort(key=lambda d: plan._axis_for(d) is None)

    a_o = a.with_dims_front([*batch, *i_dims, *Kab])
    b_o = b.with_dims_front([*batch, *j_dims, *Kab])
    assert a_o.pos_ndim == 0 and b_o.pos_ndim == 0

    nb, ni, nj = len(batch), len(i_dims), len(j_dims)
    batch_shape = tuple(a_o.data.shape[:nb])
    b_size = math.prod(batch_shape)
    i_shape = tuple(a_o.data.shape[nb:nb + ni])
    j_shape = tuple(b_o.data.shape[nb:nb + nj])
    A = reshape(a_o.data, (b_size, math.prod(i_shape), -1))
    B = reshape(b_o.data, (b_size, math.prod(j_shape), -1))

    i_size, j_size, k_size = A.shape[1], B.shape[1], A.shape[-1]
    perf.count_flops(
        matmul=2.0 * b_size * i_size * j_size * k_size,
        elementwise=(2.0 * b_size * (i_size + j_size) * k_size
                     + 2.0 * b_size * i_size * j_size))

    a_max = _finite_or_zero(settled(torch.amax(A, dim=-1, keepdim=True).detach()))
    b_max = _finite_or_zero(settled(torch.amax(B, dim=-1, keepdim=True).detach()))
    C = settled(torch.matmul(torch.exp(A - a_max), torch.exp(B - b_max).transpose(-1, -2)))
    tiny = torch.finfo(C.dtype).tiny
    out = torch.log(C + tiny) + a_max + b_max.transpose(-1, -2)
    out = reshape(out, batch_shape + i_shape + j_shape)
    return DT(out, tuple(batch) + tuple(i_dims) + tuple(j_dims))
