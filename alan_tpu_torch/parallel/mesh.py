"""Sharding the K-contraction over a device mesh (counterpart of
``alan_tpu/parallel/mesh.py``).

A ``MeshPlan`` maps dim names (K-dims, plate dims) onto the named dims of a
``torch.distributed`` ``DeviceMesh``.  ``constrain`` turns a DT's tensor
into a ``DTensor`` sharded along each planned dim that divides its mesh
axis (``Shard``) and replicated elsewhere; DTensor is the counterpart of
GSPMD here.  The DT keeps its global sizes, as GSPMD's logical shapes do,
so the named-dim algebra (``dims.py``, the planner, ``- log K``, plate
sizes) reads the same sizes sharded or not, and DTensor places the
collectives, with autograd through them.

Every rank draws the full particle tree from the same generator state, and
``constrain`` keeps each rank's shard of it without communicating, so a
planned step takes the particles of the unsharded step.  While a plan is
active (``MeshPlan.active()``) a plain tensor that meets a ``DTensor``
counts as replicated (``implicit_replication``).

The hand-written kernels, and ``dims.pos_op``'s ``torch.vmap``, run on
local tensors: ``batch_local`` redistributes their operands so that only
the leading batch axes stay sharded, every other planned axis gathered
first (as GSPMD does around a custom call), and maps the function over
the shards with ``local_map``.

Typical plans:
  * data-parallel over a large plate:  ``{"plate_1": "p"}``
  * particle-parallel over the K-dims: ``plan.with_all_K("k")``
  * sequence-parallel over a timeseries plate: ``{"T": "t"}`` (the chain
    goes to ``parallel/seq.py``)
"""
from __future__ import annotations

import contextlib
import math
import warnings

import torch

from ..dims import DT, dims_of

# The plan in force during a planned step (set by ``MeshPlan.active()``;
# consulted by ``logpq`` to route the timeseries chain to its T-sharded
# implementation and by the contraction to order sharded batch dims).
_active_plan: "MeshPlan | None" = None


def active_plan() -> "MeshPlan | None":
    return _active_plan


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_sharded(x) -> bool:
    """Whether ``x`` (a tensor or a DT) holds a ``DTensor``."""
    data = x.data if isinstance(x, DT) else x
    return isinstance(data, _dtensor())


def make_mesh(axis_sizes: dict[str, int], device_type: str | None = None):
    """A ``DeviceMesh`` with named dims ``axis_sizes`` over the ranks of the
    default process group, in rank order; their product must be the world
    size.  ``device_type`` is ``"cuda"`` unless the caller asks for
    ``"cpu"``."""
    device_type = device_type or "cuda"
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize() first")
    n = math.prod(axis_sizes.values())
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {axis_sizes} needs {n} ranks, the process "
                         f"group has {world}")
    ranks = torch.arange(n).reshape(tuple(axis_sizes.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_sizes))


class MeshPlan:
    """Maps dim names to mesh axes; constrains dimmed tensors accordingly.

    ``strict=True`` raises when a planned dim can't actually be sharded
    (size doesn't divide the mesh axis); the default warns once per
    (dim, size, axis) so a scaling run can't silently execute unsharded.
    """

    def __init__(self, mesh, dim2axis: dict[str, str], strict: bool = False):
        self.mesh = mesh
        self.dim2axis = dict(dim2axis)
        self.strict = strict
        self._warned: set = set()
        for a in self.dim2axis.values():
            self.axis_size(a)

    _k_axis: str | None = None

    def with_all_K(self, axis: str) -> "MeshPlan":
        """A plan that also shards every K-dim (any dim with the reserved
        ``K_`` prefix) over ``axis``."""
        plan = MeshPlan(self.mesh, self.dim2axis, strict=self.strict)
        self.axis_size(axis)
        plan._k_axis = axis
        return plan

    @contextlib.contextmanager
    def active(self):
        """Make this plan visible to the evaluation engine for the duration
        of a step; plain tensors that meet sharded ones count as
        replicated."""
        global _active_plan
        dispatcher = _dtensor()._op_dispatcher
        prev, prev_implicit = _active_plan, dispatcher._allow_implicit_replication
        _active_plan = self
        # ``implicit_replication()``'s switch, restored (not cleared) on the
        # way out, so that a plan entered inside another keeps it on
        dispatcher._allow_implicit_replication = True
        try:
            with warnings.catch_warnings():
                # a one-element tensor of rank > 0 (a number reshaped to
                # broadcast) is replicated, as meant
                warnings.filterwarnings("ignore", message=".*non-scalar tensor with numel=1.*")
                yield self
        finally:
            _active_plan = prev
            dispatcher._allow_implicit_replication = prev_implicit

    def axis_size(self, axis: str) -> int:
        names = self.mesh.mesh_dim_names
        if axis not in names:
            raise KeyError(f"mesh has no axis '{axis}' (axes {names})")
        return self.mesh.size(names.index(axis))

    def _undividable(self, dim: str, size: int, axis: str, axis_size: int):
        msg = (f"MeshPlan: dim '{dim}' (size {size}) does not divide mesh "
               f"axis '{axis}' (size {axis_size}); the tensor stays "
               f"UNSHARDED along '{dim}'. Pad the dim or resize the mesh.")
        if self.strict:
            raise ValueError(msg)
        key = (dim, size, axis)
        if key not in self._warned:
            self._warned.add(key)
            warnings.warn(msg, stacklevel=3)

    def _axis_for(self, dim: str):
        if dim in self.dim2axis:
            return self.dim2axis[dim]
        if self._k_axis is not None and dim.startswith("K_"):
            return self._k_axis
        return None

    def spec_for(self, x) -> tuple:
        """The mesh axis of each named dim of ``x`` (None where it is not
        planned); positional axes stay unsharded.  The counterpart of
        ``alan_tpu``'s ``PartitionSpec``."""
        return tuple(self._axis_for(d) for d in dims_of(x))

    def placements(self, dims, shape, warn: bool = True) -> list:
        """DTensor placements of a tensor whose leading axes are ``dims``:
        ``Shard(i)`` on the mesh axis of each planned dim that divides it
        (the first such dim where two share an axis), ``Replicate()``
        elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for i, d in enumerate(dims):
            a = self._axis_for(d)
            if a is None:
                continue
            n = self.axis_size(a)
            if shape[i] % n:
                if warn:
                    self._undividable(d, shape[i], a, n)
                continue
            m = names.index(a)
            if isinstance(out[m], Replicate):
                out[m] = Shard(i)
        return out

    def shard(self, data, placements):
        """``data`` laid out as ``placements`` on the plan's mesh
        (``layout``)."""
        return layout(data, self.mesh, placements)

    def constrain(self, x):
        if not isinstance(x, DT):
            return x
        if not any(a is not None for a in self.spec_for(x)) and not is_sharded(x):
            return x
        pl = self.placements(x.dims, tuple(x.data.shape))
        return DT(self.shard(x.data, pl), x.dims)

    def constrain_tree(self, tree):
        """Apply ``constrain`` to every DT leaf of a nested dict."""
        if isinstance(tree, dict):
            return {k: self.constrain_tree(v) for k, v in tree.items()}
        return self.constrain(tree)


def layout(data, mesh, placements):
    """``data`` (a tensor or a ``DTensor``) laid out as ``placements`` on
    ``mesh``.  A plain tensor counts as replicated, so that its shards are
    kept without communicating and its gradient is gathered in the
    backward."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(data, DTensor):
        data = DTensor.from_local(data, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(data.placements) == tuple(placements):
        return data
    return data.redistribute(mesh, placements)


def full(x):
    """``x`` as a plain tensor holding the global value (a sharded
    ``DTensor`` is gathered, a partial one reduced); anything else as it
    is.  DTs and nested tuples, lists and dicts are walked."""
    if isinstance(x, DT):
        return DT(full(x.data), x.dims)
    if isinstance(x, dict):
        return {k: full(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(full(v) for v in x)
    if isinstance(x, _dtensor()):
        return x.full_tensor()
    return x


def batch_local(fn, tensors, nbatch: int):
    """``fn(*tensors)`` with the ``DTensor``s among ``tensors`` mapped over
    their shards by ``local_map``: every operand is laid out with only its
    leading ``nbatch`` axes sharded (on the mesh axes that shard a batch
    axis of some operand; every other sharded axis gathered first, as
    GSPMD does around a custom call), so ``fn`` runs on local tensors of
    the same batch shard.  A batch axis of size 1 in an operand broadcasts
    (stays whole there); the others have one size in every operand, and
    ``fn``'s single output leads with them.  Plain tensors count as
    replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    pl = [Replicate()] * mesh.ndim
    taken = set()
    for t in tensors:
        if not isinstance(t, DTensor):
            continue
        for m, p in enumerate(t.placements):
            if (isinstance(p, Shard) and p.dim < nbatch and isinstance(pl[m], Replicate)
                    and p.dim not in taken):
                pl[m] = Shard(p.dim)
                taken.add(p.dim)
    per = [tuple(Replicate() if p.is_shard() and t.shape[p.dim] == 1 else p for p in pl)
           for t in tensors]
    args = [layout(t, mesh, q) for t, q in zip(tensors, per)]
    f = local_map(fn, out_placements=(tuple(pl),), in_placements=tuple(per),
                  device_mesh=mesh)
    return f(*args)
