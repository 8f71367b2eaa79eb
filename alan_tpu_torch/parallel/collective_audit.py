"""Collective inventory of a planned step, and a comm-vs-compute scaling
model (counterpart of ``alan_tpu/parallel/hlo_audit.py``).

The port has no compiled program to read, so it records collectives as
they are issued: ``collective_inventory`` runs the step under a
``TorchDispatchMode`` that sees every functional (``_c10d_functional``)
and ``c10d`` collective, the ones DTensor issues for a redistribution
included, and totals them by ``alan_tpu``'s kind names with the bytes of
their results.  ``audit_step`` checks that the expected kinds appear and
the forbidden ones do not.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["collective_inventory", "audit_step", "predict_scaling",
           "scaling_report", "labelled"]


def _kinds():
    ops = torch.ops
    table = {}

    def add(ns, names, kind):
        for n in names:
            op = getattr(ns, n, None)
            if op is not None:
                table[op] = kind
    for ns in (ops._c10d_functional, ops.c10d_functional):
        add(ns, ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                 "all_reduce_coalesced_"), "all-reduce")
        add(ns, ("all_gather_into_tensor", "all_gather_into_tensor_out",
                 "all_gather_into_tensor_coalesced"), "all-gather")
        add(ns, ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced"),
            "reduce-scatter")
        add(ns, ("all_to_all_single",), "all-to-all")
        add(ns, ("broadcast", "broadcast_"), "broadcast")
    add(ops._c10d_functional_autograd, ("all_gather_into_tensor",), "all-gather")
    add(ops._c10d_functional_autograd, ("reduce_scatter_tensor",), "reduce-scatter")
    add(ops._c10d_functional_autograd, ("all_to_all_single",), "all-to-all")
    add(ops.c10d, ("allreduce_", "allreduce_coalesced_"), "all-reduce")
    add(ops.c10d, ("allgather_", "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_"), "all-gather")
    add(ops.c10d, ("reduce_scatter_", "_reduce_scatter_base_",
                   "reduce_scatter_tensor_coalesced_"), "reduce-scatter")
    add(ops.c10d, ("alltoall_", "alltoall_base_"), "all-to-all")
    add(ops.c10d, ("send", "recv_"), "collective-permute")
    add(ops.c10d, ("broadcast_",), "broadcast")
    return table


_label: list = []


@contextlib.contextmanager
def labelled(kind: str):
    """Record the collectives issued inside as ``kind`` (``parallel/seq``'s
    point-to-point permute goes out as an all-to-all with empty splits)."""
    _label.append(kind)
    try:
        yield
    finally:
        _label.pop()


def _bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_bytes(o) for o in out)
    return 0


class _Inventory(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.kinds = _kinds()
        self.inv: dict[str, dict] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar the op into local ops and collectives
            # first; they come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = self.kinds.get(func._overloadpacket) if hasattr(func, "_overloadpacket") \
            else None
        if kind is not None:
            kind = _label[-1] if _label else kind
            e = self.inv.setdefault(kind, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += _bytes(out)
        return out


def collective_inventory(fn, *args) -> dict:
    """Run ``fn(*args)`` once and return ``{kind: {"count", "bytes"}}`` of
    the collectives it issued, forward and backward, under ``alan_tpu``'s
    kind names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``collective-permute``, ``all-to-all``); bytes are those of each
    collective's result on this rank."""
    mode = _Inventory()
    with mode:
        fn(*args)
    return mode.inv


def audit_step(fn, args, expect=(), forbid=()) -> dict:
    """Inventory one call of ``fn(*args)``; ``expect``: kinds that must
    appear, ``forbid``: kinds that must not.  Raises AssertionError
    otherwise.  Returns the inventory."""
    inv = collective_inventory(fn, *args)
    for kind in expect:
        assert kind in inv, (f"expected collective '{kind}' absent from the step; "
                             f"present: {sorted(inv)}")
    for kind in forbid:
        assert kind not in inv, (f"forbidden collective '{kind}' in the step: {inv[kind]}")
    return inv


# Per-collective wire-traffic factor for a ring implementation on n ranks:
# an all-reduce moves ~2(n-1)/n of its payload per rank (reduce-scatter +
# all-gather phases), an all-gather or reduce-scatter (n-1)/n, a permute
# exactly its payload.
_WIRE_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
    "all-to-all": lambda n: (n - 1) / n,
}

# an H100 SXM's dense TF32 peak (``perf``) and NVLink 4's 900 GB/s per GPU,
# 450 GB/s a direction
_H100_TF32 = 494.7e12
_NVLINK4 = 450e9


def predict_scaling(flops_per_step: float, inventory: dict, n_chips: int,
                    peak_flops: float = _H100_TF32,
                    achieved_frac: float = 0.04,
                    link_bytes_per_s: float = _NVLINK4,
                    step_time_s: float | None = None,
                    mode: str = "strong",
                    audited_chips: int | None = None) -> dict:
    """A first-order model, not a measurement: comm-vs-compute efficiency
    at ``n_chips``.

    Compute time: ``step_time_s`` (a measured one-card step, preferred) or
    FLOPs / (peak * achieved_frac).  ``mode``:

    * ``"strong"`` -- fixed problem, compute splits ``/ n_chips``;
      collective payloads held at their audited sizes.
    * ``"weak"`` -- per-card work held constant: compute time constant;
      all-gather / reduce-scatter / all-to-all payloads scale
      ``n_chips / audited_chips``, all-reduce payloads stay
      parameter-sized, and permute bytes scale
      ``log2(n)/log2(audited)`` (the butterfly's log2(n) rounds of
      fixed-size boundary operators, ``parallel/seq.py``).

    t_comm = sum of wire-factor(kind) * bytes / link bandwidth.  Efficiency
    = t_comp / (t_comp + t_comm) against a perfectly linear step.
    Defaults: the H100's TF32 peak and NVLink 4 at 450e9 B/s a direction
    per GPU.
    """
    t1 = (step_time_s if step_time_s is not None
          else flops_per_step / (peak_flops * achieved_frac))
    t_comp = t1 / n_chips if mode == "strong" else t1
    t_comm = 0.0
    for kind, e in inventory.items():
        factor = _WIRE_FACTOR.get(kind, lambda n: 1.0)(n_chips)
        b = e["bytes"]
        if mode == "weak" and kind != "all-reduce" and audited_chips:
            if kind == "collective-permute" and audited_chips > 1:
                b *= math.log2(n_chips) / math.log2(audited_chips)
            else:
                b *= n_chips / audited_chips
        t_comm += factor * b / link_bytes_per_s
    eff = t_comp / (t_comp + t_comm) if (t_comp + t_comm) > 0 else 1.0
    return {"n_chips": n_chips, "t_comp_s": t_comp, "t_comm_s": t_comm,
            "efficiency": eff, "mode": mode}


def scaling_report(flops_per_step: float, inventory: dict,
                   chip_counts=(8, 16, 64), **kw) -> dict:
    return {str(n): predict_scaling(flops_per_step, inventory, n, **kw)
            for n in chip_counts}
