"""Cross-K log-densities as batched matmuls, dense or lazy (counterpart of
``alan_tpu/ops/lowrank.py``; this slice ports the Normal, the one family of
the MovieLens model with a factored form).

In MP inference a latent's P-factor evaluates the child's K samples against
all K parent-conditioned densities: ``lp[K_child, K_parent, plates]``.
Exponential-family densities factorise over (sufficient statistic of x) x
(natural parameter):

    lp = sum_pos[ sum_r u_r(x) * v_r(theta) ] + sum_pos[ c(theta) ] + sum_pos[ h(x) ]

so the cross product is an inner product over (positional axes x R terms)
between an x-side matrix and a parameter-side matrix.  For the Normal,
``u = [x'^2, x']`` and ``v = [-1/(2 s^2), m'/s^2]`` with the square expanded
around a detached centre c (the mean of x over its private K-dims), which
keeps the f32 cancellation error at ~ulp * ((x - c)/s)^2 nats.

``lowrank_logprob`` materialises the product as one ``torch.matmul`` (full
f32; TF32 stays off, see ``utils.resolve_device``).  ``LowRankDT`` keeps it
lazy until the K-contraction consumes it, where ``LowRankDT.contract`` hands
it to ``ops/lowrank_kernel.lowrank_logsumexp``: the hand-written CUDA kernel
for CUDA tensors, the plain version for CPU tensors.

Routing thresholds are ``alan_tpu``'s (2^28 cross-product work, 2^26 cross
elements for the lazy form, 2^26 operand elements), so both packages route
alike.  They were calibrated on a TPU and are still to be measured on the
card.  ``ALAN_TPU_LOWRANK_MIN`` lowers the work threshold,
``ALAN_TPU_LAZY_LOWRANK=1`` forces the lazy form and
``ALAN_TPU_NO_LAZY_LOWRANK=1`` turns it off, as in ``alan_tpu``.
"""
from __future__ import annotations

import math
import os

import torch

from ..dims import DT, as_dt, unify_dims, expand_to, dimsizes_of, logsumexp_dims
from .lowrank_kernel import lowrank_logsumexp

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

#: families with a factored form in this package
LOWRANK_FAMILIES = ("Normal",)

#: cross-product elements the lazy form starts at (alan_tpu's 2^26)
_LAZY_MIN_CROSS = 1 << 26
#: cap on either factored operand, in elements (alan_tpu's 2^26)
_OPERAND_CAP = 1 << 26

#: calls of ``LowRankDT.contract`` that reached the fused contraction
CONTRACT_CALLS = 0


def _threshold() -> int:
    return int(os.environ.get("ALAN_TPU_LOWRANK_MIN", str(1 << 28)))


def lowrank_lazy_preferred(x, params) -> bool:
    """Route to the lazy factored form (``LowRankDT`` + the fused
    contraction) instead of the dense matmul: past 2^26 cross elements, or
    when forced."""
    if os.environ.get("ALAN_TPU_NO_LAZY_LOWRANK") == "1":
        return False
    if os.environ.get("ALAN_TPU_LAZY_LOWRANK") == "1":
        return True
    sizes = dimsizes_of(as_dt(x), *[as_dt(v) for v in params.values()])
    return math.prod(sizes.values()) >= _LAZY_MIN_CROSS


def lowrank_applicable(family_name, x, params, arg_dims) -> bool:
    """Route to the factored path when the sample and the parameters carry
    disjoint named dims (a genuine cross product) big enough to matter, and
    the factored operands stay bounded."""
    if family_name not in LOWRANK_FAMILIES:
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
    if u_elems > _OPERAND_CAP or v_elems > _OPERAND_CAP:
        return False
    return math.prod(sizes.values()) * F >= _threshold()


def _normal_terms(y, loc, scale, x_only):
    """Centered quadratic expansion of the Normal log-density."""
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
    """-> (u_feats, v_coefs, c_param)."""
    if family_name == "Normal":
        return _normal_terms(x, as_dt(params["loc"]), as_dt(params["scale"]), x_only)
    raise KeyError(family_name)


def _split_dims(x, pvals):
    arg_dims = tuple(unify_dims(pvals.values()))
    union = tuple(unify_dims([x, *pvals.values()]))
    x_only = tuple(d for d in x.dims if d not in arg_dims)
    p_only = tuple(d for d in arg_dims if d not in x.dims)
    shared = tuple(d for d in union if d not in x_only and d not in p_only)
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
    u = U.with_dims_front(list(shared + x_dims)).data.reshape(S, X, -1)
    v = V.with_dims_front(list(shared + p_dims)).data.reshape(S, P, -1)
    out = torch.matmul(u, v.transpose(1, 2))
    out_dims = tuple(shared) + tuple(x_dims) + tuple(p_dims)
    return DT(out.reshape(tuple(sizes[d] for d in out_dims)), out_dims)


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
            o = DT(torch.tensor(float(o), device=self.U.data.device), ())
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
        U4 = (self.U.with_dims_front(u_order).data
              .reshape(S, P, I, F).to(torch.float32).contiguous())
        V3 = (self.V.with_dims_front(list(self.shared + self.p_dims)).data
              .reshape(S, J, F).to(torch.float32).contiguous())
        if x_terms:
            d_total = x_terms[0]
            for t in x_terms[1:]:
                d_total = d_total + t
            D3 = torch.broadcast_to(
                expand_to(d_total, u_order),
                tuple(sizes[d] for d in u_order)).reshape(S, P, I)
            D3 = D3.to(torch.float32).contiguous()
        else:
            D3 = torch.zeros((S, P, I), dtype=torch.float32, device=U4.device)

        CONTRACT_CALLS += 1
        out = lowrank_logsumexp(U4, V3, D3)
        out_dims = tuple(self.shared) + tuple(kept_x) + self.p_dims
        res = DT(out.reshape(tuple(sizes[d] for d in out_dims)), out_dims)
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
    u_feats, v_coefs, c_p = _factored(family_name, x, pvals, x_only)
    U = _as_feat(u_feats, shared + x_only, sizes, pos)
    V = _as_feat(v_coefs, shared + p_only, sizes, pos)
    p_side = _side_sum(c_p, shared + p_only, sizes, pos)
    return LowRankDT(U, V, shared, x_only, p_only, sizes, p_side=p_side)
