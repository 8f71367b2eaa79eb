"""Named-dimension substrate for torch tensors.

Counterpart of ``alan_tpu/dims.py``.  A :class:`DT` ("dimmed tensor") is a
torch tensor plus a tuple of dim names: ``dims`` names the leading axes of
``data`` and the remaining trailing axes are positional.  All bookkeeping is
plain Python around ordinary tensor views, permutes and reshapes; every
operation aligns its operands by name, never by position.
"""
from __future__ import annotations

import math
import operator
from typing import Sequence

import torch

__all__ = [
    "DT", "dt", "as_dt", "is_dt", "dims_of", "dimsizes_of", "unify_dims",
    "check_unique_dims", "bind", "order", "detach", "expand_to", "align",
    "pos_op", "matmul", "elementwise", "sum_dims", "mean_dims", "prod_dims",
    "amax_dims", "amin_dims", "logsumexp_dims", "logmeanexp_dims", "sum_pos",
    "dt_index", "slice_dim", "concat_dim", "rename_dim", "reshape", "settled",
]


def _is_lazy(x) -> bool:
    return getattr(x, "__lazy_dt__", False)


class DT:
    """A torch tensor whose leading axes carry string dim names.

    ``data.shape == (*dim_sizes, *positional_shape)``.  Named dims are
    unordered semantically: every operation aligns by name.
    """

    __slots__ = ("data", "dims")

    def __init__(self, data, dims: tuple[str, ...] = ()):
        if isinstance(data, DT):
            raise TypeError("DT of DT")
        if isinstance(data, (int, float)):
            data = torch.tensor(float(data))
        elif not isinstance(data, torch.Tensor):
            raise TypeError(
                f"DT takes a torch.Tensor or a python number, not {type(data)}"
                " (numpy arrays go through alan_tpu_torch.convert)")
        dims = tuple(dims)
        if len(set(dims)) != len(dims):
            raise ValueError(f"duplicate dims {dims}")
        if data.dim() < len(dims):
            raise ValueError(f"{len(dims)} dims {dims} but data.ndim={data.dim()}")
        self.data = data
        self.dims = dims

    # -- basic properties ------------------------------------------------
    @property
    def pos_shape(self):
        return tuple(self.data.shape[len(self.dims):])

    @property
    def pos_ndim(self):
        return self.data.dim() - len(self.dims)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def dim_size(self, d: str) -> int:
        return self.data.shape[self.dims.index(d)]

    def dimsizes(self) -> dict[str, int]:
        return {d: self.data.shape[i] for i, d in enumerate(self.dims)}

    # -- reordering ------------------------------------------------------
    def order(self, *ds: str) -> "DT":
        """Move named dims ``ds`` out of the named block: they become the
        leading positional axes (torchdim ``x.order(*dims)``)."""
        for d in ds:
            if d not in self.dims:
                raise KeyError(f"dim {d} not in {self.dims}")
        rem = [d for d in self.dims if d not in ds]
        perm = ([self.dims.index(d) for d in rem]
                + [self.dims.index(d) for d in ds]
                + list(range(len(self.dims), self.data.dim())))
        return DT(self.data.permute(perm), tuple(rem))

    def with_dims_front(self, ds: Sequence[str]) -> "DT":
        """Reorder the named block so it starts with ``ds`` (all must exist)."""
        rest = [d for d in self.dims if d not in ds]
        new = tuple(ds) + tuple(rest)
        perm = ([self.dims.index(d) for d in new]
                + list(range(len(self.dims), self.data.dim())))
        return DT(self.data.permute(perm), new)

    # -- arithmetic ------------------------------------------------------
    def _binop(self, other, f):
        if _is_lazy(other):
            # lazy factored log-prob (ops/lowrank.LowRankDT): let its
            # reflected op absorb or materialise
            return NotImplemented
        return elementwise(f, self, other)

    def __add__(self, o): return self._binop(o, operator.add)
    def __radd__(self, o): return elementwise(operator.add, o, self)
    def __sub__(self, o): return self._binop(o, operator.sub)
    def __rsub__(self, o): return elementwise(operator.sub, o, self)
    def __mul__(self, o): return self._binop(o, operator.mul)
    def __rmul__(self, o): return elementwise(operator.mul, o, self)
    def __truediv__(self, o): return self._binop(o, operator.truediv)
    def __rtruediv__(self, o): return elementwise(operator.truediv, o, self)
    def __pow__(self, o): return self._binop(o, operator.pow)
    def __neg__(self): return DT(-self.data, self.dims)
    def __matmul__(self, o): return matmul(self, o)
    def __rmatmul__(self, o): return matmul(o, self)

    def exp(self): return DT(torch.exp(self.data), self.dims)
    def log(self): return DT(torch.log(self.data), self.dims)
    def sqrt(self): return DT(torch.sqrt(self.data), self.dims)
    def sigmoid(self): return DT(torch.sigmoid(self.data), self.dims)
    def abs(self): return DT(torch.abs(self.data), self.dims)

    def sum(self, ds=None):
        if ds is None:
            return sum_pos(self)
        if isinstance(ds, str):
            ds = (ds,)
        return sum_dims(self, ds)

    def __repr__(self):
        return (f"DT(dims={self.dims}, pos_shape={self.pos_shape}, "
                f"dtype={self.data.dtype}, device={self.data.device})")


# -- constructors / predicates ------------------------------------------

def dt(data, *dims: str) -> DT:
    return DT(data, dims)


def is_dt(x) -> bool:
    return isinstance(x, DT)


def as_dt(x):
    if isinstance(x, DT) or _is_lazy(x):
        return x  # a lazy factored log-prob duck-types the DT dim protocol
    return DT(x, ())


def dims_of(x) -> tuple[str, ...]:
    if isinstance(x, DT) or _is_lazy(x):
        return x.dims
    return ()


def dimsizes_of(*xs) -> dict[str, int]:
    out: dict[str, int] = {}
    for x in xs:
        if isinstance(x, DT):
            for d, s in x.dimsizes().items():
                if d in out and out[d] != s:
                    raise ValueError(f"dim {d} has conflicting sizes {out[d]} vs {s}")
                out[d] = s
    return out


def unify_dims(xs) -> list[str]:
    """Unique ordered list of dims across xs."""
    seen: dict[str, None] = {}
    for x in xs:
        for d in dims_of(x):
            seen.setdefault(d, None)
    return list(seen)


def check_unique_dims(ds):
    if len(set(ds)) != len(ds):
        raise ValueError(f"non-unique dims {ds}")


def bind(x, *names: str) -> DT:
    """Bind the first positional axes of ``x`` to ``names``."""
    x = as_dt(x)
    for n in names:
        if n in x.dims:
            raise ValueError(f"dim {n} already bound in {x.dims}")
    if x.pos_ndim < len(names):
        raise ValueError(f"cannot bind {names}: only {x.pos_ndim} positional axes")
    return DT(x.data, x.dims + tuple(names))


def order(x, ds) -> DT:
    if isinstance(ds, str):
        ds = (ds,)
    return as_dt(x).order(*ds)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``.  A host tensor of one element (a number made a
    tensor, perhaps reshaped) becomes a fill on the card, not a copy: a
    CUDA graph's capture refuses a copy from pageable host memory."""
    device = torch.device(device)
    if (t.device.type == "cpu" and device.type != "cpu" and t.numel() == 1
            and not t.requires_grad):
        return torch.full(t.shape, t.item(), dtype=t.dtype, device=device)
    return t.to(device)


def detach(x):
    if isinstance(x, DT):
        return DT(x.data.detach(), x.dims)
    return x.detach() if isinstance(x, torch.Tensor) else x


def rename_dim(x, old: str, new: str) -> DT:
    """Relabel a named dim (a timeseries sample's K-dim viewed as the lagged
    Kinit-dim)."""
    x = as_dt(x)
    if new in x.dims:
        raise ValueError(f"dim {new} already present in {x.dims}")
    return DT(x.data, tuple(new if d == old else d for d in x.dims))


# -- alignment & elementwise ops ----------------------------------------

def _expand_named(x: DT, union: Sequence[str]):
    """Raw tensor with named block == union (size-1 for missing dims),
    positional block unchanged."""
    x = x.with_dims_front([d for d in union if d in x.dims])
    pos = list(x.data.shape[len(x.dims):])
    sizes = x.dimsizes()
    full = [sizes.get(d, 1) for d in union]
    return x.data.reshape([*full, *pos])


def expand_to(x, union: Sequence[str]):
    """Raw tensor for ``x`` with named block exactly ``union`` (size-1 where
    missing), positional block unchanged.  ``x.dims`` must lie in union."""
    x = as_dt(x)
    for d in x.dims:
        if d not in union:
            raise KeyError(f"dim {d} of operand not in target dims {union}")
    return _expand_named(x, union)


def align(*xs, extra: Sequence[str] = ()):
    """Align values over the union of their named dims: returns
    ``(tensors, union_dims)`` with each tensor shaped
    ``(*union_sizes_or_1, *its_own_positional_shape)``."""
    dts = [as_dt(x) for x in xs]
    union = unify_dims(dts)
    for d in extra:
        if d not in union:
            union.append(d)
    dimsizes_of(*dts)  # consistency check
    return [_expand_named(x, union) for x in dts], tuple(union)


def pos_op(f, *xs) -> DT:
    """Apply ``f`` to the positional blocks of the operands, vectorised over
    the union of named dims (for ops like ``matmul`` whose meaning depends
    on operand rank): the named dims are flattened to one batch axis and
    ``f`` is mapped over it with ``torch.vmap``.  Sharded operands map over
    their shards (``parallel.mesh.batch_local``)."""
    dts = [as_dt(x) for x in xs]
    if not any(x.dims for x in dts):
        return DT(f(*[x.data for x in dts]), ())
    arrs, union = align(*dts)
    sizes = [max(a.shape[i] for a in arrs) for i in range(len(union))]
    full = [torch.broadcast_to(a, tuple(sizes) + tuple(a.shape[len(union):]))
            for a in arrs]
    from .parallel.mesh import batch_local, is_sharded
    if any(is_sharded(a) for a in full):
        # sharded operands (a MeshPlan): nested vmaps over the intact named
        # axes of each shard; a reshape merging a sharded dim anywhere but
        # majormost would gather it whole first
        def g(*xs):
            h = f
            for _ in union:
                h = torch.vmap(h)
            return h(*xs)
        return DT(batch_local(g, full, len(union)), union)
    flat = [a.reshape((-1,) + tuple(a.shape[len(union):])) for a in full]
    out = torch.vmap(f)(*flat)
    return DT(out.reshape(tuple(sizes) + tuple(out.shape[1:])), union)


def matmul(a, b) -> DT:
    """``a @ b`` on the positional blocks, vectorised over the named dims.

    A vector . vector product (one positional axis each, as in a model's
    ``z @ x`` logits) is one ``torch.einsum`` over the aligned operands: the
    named dims stay broadcast and the product runs as a batched matmul over
    the dims both operands carry.  Mapping ``torch.matmul`` over the
    flattened named dims instead (``pos_op``, kept for the other ranks)
    would copy both operands out to the full cross product of their dims
    and run one tiny dot per element of it."""
    a, b = as_dt(a), as_dt(b)
    if a.pos_ndim == 1 and b.pos_ndim == 1:
        (x, y), union = align(a, b)
        dtype = torch.promote_types(x.dtype, y.dtype)     # as jnp.einsum
        x, y = x.to(dtype), y.to(dtype)
        dot = lambda u, v: torch.einsum("...f,...f->...", u, v)
        from .parallel.mesh import batch_local, is_sharded
        if is_sharded(x) or is_sharded(y):
            # einsum flattens the named dims into one, which a sharded dim
            # that is not majormost cannot take: map it over the shards
            return DT(batch_local(dot, [x, y], len(union)), union)
        return DT(dot(x, y), union)
    return pos_op(torch.matmul, a, b)


def elementwise(f, *xs) -> DT:
    """Apply positional-broadcasting ``f`` across aligned dimmed args."""
    if not any(isinstance(x, DT) and x.dims for x in xs):
        return DT(f(*[x.data if isinstance(x, DT) else x for x in xs]), ())
    # python numbers and 0-d tensors without dims broadcast as they are (a
    # 0-d CPU tensor may meet CUDA tensors; a reshaped one may not)
    def is_scalar(x):
        return not isinstance(x, (DT, torch.Tensor)) or (
            not dims_of(x) and as_dt(x).data.dim() == 0)

    arrs, union = align(*[x for x in xs if not is_scalar(x)])
    # positional blocks broadcast right-aligned; named blocks lead and have
    # the same length, so pad positional ranks to a common rank
    max_pos = max(a.dim() - len(union) for a in arrs)
    padded = iter([a.reshape(tuple(a.shape[:len(union)])
                             + (1,) * (max_pos - (a.dim() - len(union)))
                             + tuple(a.shape[len(union):])) for a in arrs])
    args = [(x.data if isinstance(x, DT) else x) if is_scalar(x) else next(padded)
            for x in xs]
    return DT(f(*args), union)


# -- reductions over named dims -----------------------------------------

_DTENSOR = []


def _dtensor_types():
    """(DTensor, Replicate), imported at first use."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor, Replicate
        _DTENSOR.extend((DTensor, Replicate))
    return _DTENSOR


def reshape(t, shape):
    """``t.reshape(shape)``.  A sharded ``DTensor`` first gathers each
    sharded dim that the reshape merges anywhere but majormost in its
    output dim (GSPMD's merge-gather, made explicit: DTensor refuses such
    a view); a sharded dim that leads its group keeps its shard."""
    DTensor, Replicate = _dtensor_types()
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    src = tuple(t.shape)
    shape = list(shape)
    if -1 in shape:
        i = shape.index(-1)
        shape[i] = math.prod(src) // math.prod(d for d in shape if d != -1)
    starts = {math.prod(shape[:j]) for j in range(len(shape) + 1)}
    pl = [Replicate() if p.is_shard() and src[p.dim] > 1
          and math.prod(src[:p.dim]) not in starts else p for p in t.placements]
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return t.reshape(shape)


def settled(t):
    """``t`` with any partial placement of a sharded ``DTensor`` reduced at
    once (an all-reduce of the reduction's result), as GSPMD reduces a
    sharded reduction: a partial left for DTensor to settle later may be
    reduce-scattered onto another dim, which the next op then gathers
    whole.  Anything else as it is."""
    DTensor, Replicate = _dtensor_types()
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in t.placements])
    return t


def _reduce(fn):
    def inner(x, ds, ignore_extra_dims: bool = False):
        x = as_dt(x)
        if isinstance(ds, str):
            ds = (ds,)
        check_unique_dims(tuple(ds))
        if ignore_extra_dims:
            ds = tuple(d for d in ds if d in x.dims)
        for d in ds:
            if d not in x.dims:
                raise KeyError(f"reduction dim {d} not in {x.dims}")
        if len(ds) == 0:
            return x
        o = x.order(*ds)
        axes = tuple(range(len(o.dims), len(o.dims) + len(ds)))
        return DT(settled(fn(o.data, axes)), o.dims)
    return inner


sum_dims = _reduce(lambda a, ax: torch.sum(a, dim=ax))
mean_dims = _reduce(lambda a, ax: torch.mean(a, dim=ax))
# torch.prod takes one dim: the reduced axes are adjacent, so flatten them
prod_dims = _reduce(lambda a, ax: torch.prod(a.flatten(ax[0], ax[-1]), dim=ax[0]))
amax_dims = _reduce(lambda a, ax: torch.amax(a, dim=ax))
amin_dims = _reduce(lambda a, ax: torch.amin(a, dim=ax))


def logsumexp_dims(x, ds, ignore_extra_dims: bool = False) -> DT:
    """eps-stabilised logsumexp over named dims (``alan_tpu/dims.py:370``):
    subtract the detached max (0 where it is not finite), exp, sum, add
    ``eps`` inside the log so all--inf slices stay finite."""
    x = as_dt(x)
    if isinstance(ds, str):
        ds = (ds,)
    check_unique_dims(tuple(ds))
    if ignore_extra_dims:
        ds = tuple(d for d in ds if d in x.dims)
    for d in ds:
        if d not in x.dims:
            raise KeyError(f"reduction dim {d} not in {x.dims}")
    if len(ds) == 0:
        return x
    o = x.order(*ds)
    axes = tuple(range(len(o.dims), len(o.dims) + len(ds)))
    a = o.data
    a_max = settled(torch.amax(a, dim=axes, keepdim=True).detach())
    a_max = torch.where(torch.isfinite(a_max), a_max, torch.zeros_like(a_max))
    s = settled(torch.sum(torch.exp(a - a_max), dim=axes))
    eps = torch.finfo(s.dtype).eps
    out = torch.log(s + eps) + a_max.reshape(s.shape)
    return DT(out, o.dims)


def logmeanexp_dims(x, ds) -> DT:
    x = as_dt(x)
    if isinstance(ds, str):
        ds = (ds,)
    total = sum(math.log(x.dim_size(d)) for d in ds)
    r = logsumexp_dims(x, ds)
    return DT(r.data - total, r.dims)


def sum_pos(x):
    """Sum over all positional axes."""
    if not isinstance(x, DT):
        return torch.sum(x) if isinstance(x, torch.Tensor) and x.dim() > 0 else x
    if x.pos_ndim == 0:
        return x
    axes = tuple(range(len(x.dims), x.data.dim()))
    return DT(torch.sum(x.data, dim=axes), x.dims)


# -- gather / indexing ---------------------------------------------------

def dt_index(x, dim: str, idx) -> DT:
    """Gather along named ``dim`` of ``x`` with integer indices ``idx``
    (torchdim's ``x.order(dim)[idx]``): the result's named dims are
    ``(x.dims - {dim}) + idx.dims`` and its positional shape is
    ``(*idx.pos_shape, *x.pos_shape)``."""
    x = as_dt(x)
    idx = as_dt(idx)
    if dim not in x.dims:
        raise KeyError(f"{dim} not in {x.dims}")

    common = [d for d in x.dims if d != dim]
    for d in idx.dims:
        if d not in common:
            common.append(d)
    nC = len(common)
    n_ipos = idx.pos_ndim
    n_xpos = x.pos_ndim

    # x arranged: (*common_or_1, S, *1s(idx_pos), *x_pos)
    xa = _expand_named(x.order(dim), common)
    xa = xa.reshape(tuple(xa.shape[:nC + 1]) + (1,) * n_ipos
                    + tuple(xa.shape[nC + 1:]))
    # idx arranged: (*common_or_1, 1, *idx_pos, *1s(x_pos))
    ia = _expand_named(idx, common)
    ia = ia.reshape(tuple(ia.shape[:nC]) + (1,) + tuple(ia.shape[nC:])
                    + (1,) * n_xpos)

    out = torch.take_along_dim(xa, ia, dim=nC).squeeze(nC)
    return DT(out, tuple(common))


def slice_dim(x, dim: str, start: int, stop: int) -> DT:
    """Static slice ``[start, stop)`` along a named dim (the original plate
    region of a predictive log-likelihood)."""
    o = as_dt(x).order(dim)
    return bind(DT(o.data.narrow(len(o.dims), start, stop - start), o.dims), dim)


def concat_dim(xs: Sequence[DT], dim: str) -> DT:
    """Concatenate along a named dim; every operand must carry the same
    other dims (in any order)."""
    os_ = [as_dt(x).order(dim) for x in xs]
    ref = os_[0].dims
    if any(set(o.dims) != set(ref) for o in os_):
        raise ValueError("concat_dim: mismatched dims")
    arrs = [o.with_dims_front(ref).data for o in os_]
    return bind(DT(torch.cat(arrs, dim=len(ref)), ref), dim)
