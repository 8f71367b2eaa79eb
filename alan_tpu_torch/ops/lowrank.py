"""Cross-K log-densities as batched matmuls, dense or lazy (counterpart of
``alan_tpu/ops/lowrank.py``, with its six factored families).

In MP inference a latent's P-factor evaluates the child's K samples against
all K parent-conditioned densities: ``lp[K_child, K_parent, plates]``.
Exponential-family densities factorise over (sufficient statistic of x) x
(natural parameter):

    lp = sum_pos[ sum_r u_r(x) * v_r(theta) ] + sum_pos[ c(theta) ] + sum_pos[ h(x) ]

so the cross product is an inner product over (positional axes x R terms)
between an x-side matrix and a parameter-side matrix.  Factored forms:

    Normal      u = [x'^2, x']          v = [-1/(2 s^2), m'/s^2]  (centred)
    LogNormal   the Normal on log x     h(x) = -log x
    Exponential u = [x]                 v = [-rate]
    Gamma, Chi2 u = [log x, x]          v = [conc - 1, -rate]
    Beta        u = [log x, log1p(-x)]  v = [c1 - 1, c0 - 1]

For the Normal the square is expanded around a detached centre c (the mean
of x over its private K-dims), which keeps the f32 cancellation error at
~ulp * ((x - c)/s)^2 nats.  The other forms are exact algebra.  So the
lazy factor's rank F (its features per positional element) is 2, or 1 for
the Exponential.

``lowrank_logprob`` materialises the product as one ``torch.matmul`` (full
f32; TF32 stays off, see ``utils.resolve_device``).  ``LowRankDT`` keeps it
lazy until the K-contraction consumes it, where ``LowRankDT.contract`` hands
it to ``ops/lowrank_kernel.lowrank_logsumexp``: the hand-written CUDA kernel
for CUDA tensors, the plain version for CPU tensors.

Routing reads ``alan_tpu``'s knobs with its defaults, at each call, so both
packages route alike under one environment: ``ALAN_TPU_LOWRANK_MIN`` (the
cross-product work the factored path starts at, 2^28),
``ALAN_TPU_NO_LOWRANK_LOGPROB=1`` (no factored path at all),
``ALAN_TPU_LOWRANK_OPERAND_CAP`` (largest factored operand, 2^26 elements),
``ALAN_TPU_LAZY_LOWRANK_MIN`` (cross elements the lazy form starts at,
2^26), ``ALAN_TPU_LAZY_LOWRANK=1`` (lazy form forced) and
``ALAN_TPU_NO_LAZY_LOWRANK=1`` (lazy form off).  The defaults were
calibrated on a TPU and are still to be measured on the card.
``ALAN_TPU_LAZY_LOWRANK_INTERPRET`` (run the Pallas kernel in interpret
mode) has no counterpart here: a CPU tensor always takes the plain version.
"""
from __future__ import annotations

import math
import os

import torch

from .. import perf
from ..dims import (DT, as_dt, unify_dims, expand_to, dimsizes_of, logsumexp_dims,
                    reshape, elementwise as ew)
from .lowrank_kernel import lowrank_logsumexp

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

#: families with a factored form (Chi2 canonicalises to the Gamma's
#: parameters and shares its form)
LOWRANK_FAMILIES = ("Normal", "LogNormal", "Exponential", "Gamma", "Chi2",
                    "Beta")

#: calls of ``LowRankDT.contract`` that reached the fused contraction
CONTRACT_CALLS = 0


def _threshold() -> int:
    """Cross-product work (elements x features) the factored path starts at."""
    return int(os.environ.get("ALAN_TPU_LOWRANK_MIN", str(1 << 28)))


def _lazy_min_cross() -> int:
    """Cross-product elements the lazy form starts at."""
    return int(os.environ.get("ALAN_TPU_LAZY_LOWRANK_MIN", str(1 << 26)))


def _operand_cap() -> int:
    """Largest factored operand, in elements."""
    return int(os.environ.get("ALAN_TPU_LOWRANK_OPERAND_CAP", str(1 << 26)))


def lowrank_lazy_preferred(x, params) -> bool:
    """Route to the lazy factored form (``LowRankDT`` + the fused
    contraction) instead of the dense matmul: from ``_lazy_min_cross()``
    cross elements on, or when forced."""
    if os.environ.get("ALAN_TPU_NO_LAZY_LOWRANK") == "1":
        return False
    if os.environ.get("ALAN_TPU_LAZY_LOWRANK") == "1":
        return True
    sizes = dimsizes_of(as_dt(x), *[as_dt(v) for v in params.values()])
    return math.prod(sizes.values()) >= _lazy_min_cross()


def lowrank_applicable(family_name, x, params, arg_dims) -> bool:
    """Route to the factored path when the sample and the parameters carry
    disjoint named dims (a genuine cross product) big enough to matter, and
    the factored operands stay bounded."""
    if family_name not in LOWRANK_FAMILIES:
        return False
    if os.environ.get("ALAN_TPU_NO_LOWRANK_LOGPROB") == "1":
        return False
    x = as_dt(x)
    p_only = [d for d in arg_dims if d not in x.dims]
    x_only = [d for d in x.dims if d not in arg_dims]
    if not p_only or not x_only:
        return False
    pvals = [as_dt(v) for v in params.values()]
    sizes = dimsizes_of(x, *pvals)
    F = math.prod(torch.broadcast_shapes(x.pos_shape, *[v.pos_shape for v in pvals]))
    u_elems = math.prod(sizes[d] for d in sizes if d not in p_only) * F
    v_elems = math.prod(sizes[d] for d in p_only) * F
    cap = _operand_cap()
    if u_elems > cap or v_elems > cap:
        return False
    return math.prod(sizes.values()) * F >= _threshold()


def _normal_terms(y, loc, scale, x_only):
    """Centred quadratic expansion shared by the Normal and the LogNormal."""
    yo = y.with_dims_front(list(x_only))
    c0 = DT(torch.mean(yo.data, dim=tuple(range(len(x_only)))).detach(),
            yo.dims[len(x_only):])
    yc = y - c0
    locc = loc - c0
    inv = 1.0 / (scale * scale)
    u = [yc * yc, yc]
    v = [inv * (-0.5), locc * inv]
    c_p = locc * locc * inv * (-0.5) - scale.log() - _HALF_LOG_2PI
    return u, v, c_p


def _factored(family_name, x, params, x_only):
    """-> (u_feats, v_coefs, c_param, c_x): the x-side features, the
    parameter-side coefficients, the x-free term and the parameter-free
    term (None where there is none)."""
    if family_name == "Normal":
        u, v, c_p = _normal_terms(x, params["loc"], params["scale"], x_only)
        return u, v, c_p, None
    if family_name == "LogNormal":
        lx = x.log()
        u, v, c_p = _normal_terms(lx, params["loc"], params["scale"], x_only)
        return u, v, c_p, -lx
    if family_name == "Exponential":
        rate = params["rate"]
        return [x], [-rate], rate.log(), None
    if family_name in ("Gamma", "Chi2"):
        a, b = params["concentration"], params["rate"]
        c_p = a * b.log() - ew(torch.lgamma, a)
        return [x.log(), x], [a - 1.0, -b], c_p, None
    if family_name == "Beta":
        a, b = params["concentration1"], params["concentration0"]
        c_p = ew(torch.lgamma, a + b) - ew(torch.lgamma, a) - ew(torch.lgamma, b)
        return [x.log(), ew(torch.log1p, -x)], [a - 1.0, b - 1.0], c_p, None
    raise KeyError(family_name)


def _shard_major(shared):
    """The shared (batch) dims with mesh-mapped ones first: they are
    reshape-merged into one flat batch axis, which keeps a dim's sharding
    only when that dim is majormost (``alan_tpu``'s ``lowrank.py:205-216``)."""
    from ..parallel.mesh import active_plan
    shared = tuple(shared)
    plan = active_plan()
    if plan is not None and len(shared) > 1:
        shared = tuple(sorted(shared, key=lambda d: plan._axis_for(d) is None))
    return shared


def _split_dims(x, pvals):
    arg_dims = tuple(unify_dims(pvals.values()))
    union = tuple(unify_dims([x, *pvals.values()]))
    x_only = tuple(d for d in x.dims if d not in arg_dims)
    p_only = tuple(d for d in arg_dims if d not in x.dims)
    shared = _shard_major(d for d in union if d not in x_only and d not in p_only)
    sizes = dimsizes_of(x, *pvals.values())
    pos = tuple(torch.broadcast_shapes(x.pos_shape,
                                       *[v.pos_shape for v in pvals.values()]))
    return x_only, p_only, shared, sizes, pos


def _as_feat(terms, dims_order, sizes, pos) -> DT:
    """Stack feature terms into one DT with dims ``dims_order`` and a single
    positional axis of length ``len(terms) * prod(pos)``."""
    cols = []
    nd = len(dims_order)
    full = tuple(sizes[d] for d in dims_order) + tuple(pos)
    for t in terms:
        a = expand_to(t, dims_order)
        own_pos = tuple(a.shape[nd:])
        if len(own_pos) < len(pos):
            a = a.reshape(tuple(a.shape[:nd]) + (1,) * (len(pos) - len(own_pos))
                          + own_pos)
        cols.append(torch.broadcast_to(a, full).reshape(full[:nd] + (-1,)))
    return DT(torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0],
              tuple(dims_order))


def _side_sum(t, dims_order, sizes, pos) -> DT:
    """Positional sum of a side term, broadcast over ``pos`` first."""
    return DT(_as_feat([t], dims_order, sizes, pos).data.sum(-1),
              tuple(dims_order))


def _dense_product(U: DT, V: DT, shared, x_dims, p_dims, sizes) -> DT:
    """``U . V`` over the feature axis as one batched matmul, dims
    ``shared + x_dims + p_dims``."""
    S = math.prod(sizes[d] for d in shared)
    X = math.prod(sizes[d] for d in x_dims)
    P = math.prod(sizes[d] for d in p_dims)
    u = reshape(U.with_dims_front(list(shared + x_dims)).data, (S, X, -1))
    v = reshape(V.with_dims_front(list(shared + p_dims)).data, (S, P, -1))
    perf.count_flops(matmul=2.0 * S * X * P * u.shape[-1])
    out = torch.matmul(u, v.transpose(1, 2))
    out_dims = tuple(shared) + tuple(x_dims) + tuple(p_dims)
    return DT(reshape(out, tuple(sizes[d] for d in out_dims)), out_dims)


def lowrank_logprob(family_name, x, params) -> DT:
    """``sum_pos(family(params).log_prob(x))`` over the cross product of
    x-dims and param-dims, via one batched matmul.  Returns a DT with dims
    ``x.dims + param dims`` and no positional axes."""
    return lowrank_logprob_lazy(family_name, x, params).materialize()


class LowRankDT:
    """Lazy cross-K factored log-density: semantically the DT

        lp[shared, x_dims, p_dims] = U . V  (+ x_side) (+ p_side)

    with U carrying (shared, x_dims) and V (shared, p_dims), inner product
    over one positional feature axis.  Duck-types the DT dim protocol so it
    can ride the contraction planner; ``+``/``-`` absorb terms that live on
    one side and fall back to ``materialize()`` otherwise.
    """
    __lazy_dt__ = True

    def __init__(self, U: DT, V: DT, shared, x_dims, p_dims, sizes,
                 x_side: DT | None = None, p_side: DT | None = None):
        self.U, self.V = U, V
        self.shared = tuple(shared)
        self.x_dims = tuple(x_dims)
        self.p_dims = tuple(p_dims)
        self.sizes = dict(sizes)
        self.x_side, self.p_side = x_side, p_side

    # -- DT dim protocol --
    @property
    def dims(self):
        return self.shared + self.x_dims + self.p_dims

    @property
    def pos_ndim(self):
        return 0

    @property
    def pos_shape(self):
        return ()

    def dim_size(self, d):
        return self.sizes[d]

    def dimsizes(self):
        return {d: self.sizes[d] for d in self.dims}

    def __repr__(self):
        return (f"LowRankDT(shared={self.shared}, x={self.x_dims}, "
                f"p={self.p_dims}, F={self.U.pos_shape[-1]})")

    # -- arithmetic: absorb one-sided terms, else materialise --
    def _replace(self, **kw):
        args = dict(U=self.U, V=self.V, shared=self.shared,
                    x_dims=self.x_dims, p_dims=self.p_dims, sizes=self.sizes,
                    x_side=self.x_side, p_side=self.p_side)
        args.update(kw)
        return LowRankDT(**args)

    def _try_absorb(self, o, neg=False):
        if getattr(o, "__lazy_dt__", False):
            return None
        if isinstance(o, (int, float)):
            if o == 0:
                return self
            # a fill on the card, not a host tensor copied there: a CUDA
            # graph's capture refuses a copy from pageable host memory
            o = DT(torch.full((), float(o), device=self.U.data.device), ())
        elif isinstance(o, DT):
            if o.pos_ndim != 0:
                return None
        elif isinstance(o, torch.Tensor) and o.dim() == 0:
            o = DT(o, ())
        else:
            return None
        if neg:
            o = -o
        od = set(o.dims)
        if od <= set(self.shared) | set(self.x_dims):
            return self._replace(
                x_side=o if self.x_side is None else self.x_side + o)
        if od <= set(self.shared) | set(self.p_dims):
            return self._replace(
                p_side=o if self.p_side is None else self.p_side + o)
        return None

    def __add__(self, o):
        r = self._try_absorb(o)
        if r is not None:
            return r
        o = o.materialize() if getattr(o, "__lazy_dt__", False) else o
        return self.materialize() + o

    __radd__ = __add__

    def __sub__(self, o):
        r = self._try_absorb(o, neg=True)
        if r is not None:
            return r
        o = o.materialize() if getattr(o, "__lazy_dt__", False) else o
        return self.materialize() - o

    def __rsub__(self, o):
        return as_dt(o) - self.materialize()

    def __neg__(self):
        return -self.materialize()

    # -- evaluation --
    def materialize(self) -> DT:
        """Dense evaluation: the cross product as one batched matmul plus
        the side terms."""
        res = _dense_product(self.U, self.V, self.shared, self.x_dims,
                             self.p_dims, self.sizes)
        if self.x_side is not None:
            res = res + self.x_side
        if self.p_side is not None:
            res = res + self.p_side
        return res

    def contract(self, Ks, others) -> DT | None:
        """``logsumexp_{Ks}(self + sum(others))`` through the fused
        contraction, or None if these factors don't fit its form (the caller
        then materialises).  The kernel takes any sizes, so on a CUDA tensor
        a factor of this form always reaches it."""
        global CONTRACT_CALLS
        Kset = set(Ks)
        if not Kset or not Kset <= set(self.dims):
            return None
        if any(d in Kset for d in self.shared):
            return None
        red_x = [d for d in self.x_dims if d in Kset]
        red_p = [d for d in self.p_dims if d in Kset]
        if not red_x:
            if not red_p:
                return None
            # the reduction hits only the parameter side (an observation
            # factor whose params carry the parent's K-dim): the factored
            # form is symmetric in (U, x) <-> (V, p), so swap roles
            swapped = LowRankDT(self.V, self.U, self.shared, self.p_dims,
                                self.x_dims, self.sizes,
                                x_side=self.p_side, p_side=self.x_side)
            return swapped.contract(Ks, others)

        x_set = set(self.shared) | set(self.x_dims)
        p_set = set(self.shared) | set(self.p_dims)
        x_terms = [] if self.x_side is None else [self.x_side]
        p_terms = [] if self.p_side is None else [self.p_side]
        for o in others:
            if getattr(o, "__lazy_dt__", False):
                return None
            o = as_dt(o)
            if o.pos_ndim != 0:
                return None
            if set(o.dims) <= x_set:
                x_terms.append(o)
            elif set(o.dims) <= p_set:
                p_terms.append(o)
            else:
                return None

        sizes = self.sizes
        kept_x = [d for d in self.x_dims if d not in Kset]
        S = math.prod(sizes[d] for d in self.shared)
        P = math.prod(sizes[d] for d in kept_x)
        I = math.prod(sizes[d] for d in red_x)
        J = math.prod(sizes[d] for d in self.p_dims)
        F = self.U.pos_shape[-1]

        u_order = list(self.shared) + kept_x + red_x
        U4 = reshape(self.U.with_dims_front(u_order).data,
                     (S, P, I, F)).to(torch.float32).contiguous()
        V3 = reshape(self.V.with_dims_front(list(self.shared + self.p_dims)).data,
                     (S, J, F)).to(torch.float32).contiguous()
        if x_terms:
            d_total = x_terms[0]
            for t in x_terms[1:]:
                d_total = d_total + t
            D3 = reshape(torch.broadcast_to(
                expand_to(d_total, u_order),
                tuple(sizes[d] for d in u_order)), (S, P, I))
            D3 = D3.to(torch.float32).contiguous()
        else:
            D3 = torch.zeros((S, P, I), dtype=torch.float32, device=U4.device)

        CONTRACT_CALLS += 1
        perf.count_flops(matmul=2.0 * S * P * I * J * F, elementwise=4.0 * S * P * I * J)
        from ..parallel.mesh import batch_local, is_sharded
        if any(is_sharded(t) for t in (U4, V3, D3)):
            out = batch_local(lowrank_logsumexp, [U4, V3, D3], 1)
        else:
            out = lowrank_logsumexp(U4, V3, D3)
        out_dims = tuple(self.shared) + tuple(kept_x) + self.p_dims
        res = DT(reshape(out, tuple(sizes[d] for d in out_dims)), out_dims)
        for t in p_terms:
            res = res + t
        if red_p:
            res = logsumexp_dims(res, tuple(red_p))
        return res


def lowrank_logprob_lazy(family_name, x, params) -> LowRankDT:
    """Lazy form of ``lowrank_logprob``: same factored algebra, the cross
    product deferred to the consuming K-contraction."""
    x = as_dt(x)
    pvals = {k: as_dt(v) for k, v in params.items()}
    x_only, p_only, shared, sizes, pos = _split_dims(x, pvals)
    u_feats, v_coefs, c_p, c_x = _factored(family_name, x, pvals, x_only)
    U = _as_feat(u_feats, shared + x_only, sizes, pos)
    V = _as_feat(v_coefs, shared + p_only, sizes, pos)
    p_side = _side_sum(c_p, shared + p_only, sizes, pos)
    x_side = None if c_x is None else _side_sum(c_x, shared + x_only, sizes, pos)
    return LowRankDT(U, V, shared, x_only, p_only, sizes,
                     x_side=x_side, p_side=p_side)
