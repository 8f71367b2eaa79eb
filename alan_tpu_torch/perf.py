"""FLOP accounting and model FLOP utilisation on the card (counterpart of
``alan_tpu/perf.py``).

Two FLOP counts per step:

* ``analytic_flops`` -- the engine's hot ops (the K-contraction's
  log-space matmuls and broadcast sums, the factored cross-K log-densities,
  the timeseries chain) call ``count_flops`` with their model FLOPs,
  computed from their shapes, at the op and not in a kernel wrapper, so the
  plain route, cuBLAS and a hand kernel of one op count the same.
  Convention (``alan_tpu``'s): forward model FLOPs (2mnk a matmul, about k
  an element for a k-op elementwise chain); a program that takes one
  gradient costs forward + 2x forward, 3x in all.
* ``op_cost`` -- ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the aten matmuls that actually ran.

Peak table, keyed on ``torch.cuda.get_device_name()`` (NVIDIA's data
sheets, dense rates).  The denominator of ``mfu`` is the TF32 tensor-core
peak, not the float32 one: the port's lazy low-rank and fused log-matmul
kernels run float32 data through 3xTF32 ``wgmma``, so a share against the
67e12 float32 rate could read over 1 for them, while TF32 is the highest
rate at which this card multiplies the port's float32 data at all, and a
share against it cannot.  The float32 share is reported beside it as
``fp32_share``.  The power limit stands beside every rate: a card set below
700 W runs slower under load.
"""
from __future__ import annotations

import contextlib
import subprocess

import torch

# device name substring -> (FP32, TF32 tensor core, BF16 tensor core,
# HBM bytes/s), dense
_PEAKS = [
    ("H100 80GB HBM3", (66.9e12, 494.7e12, 989.4e12, 3.35e12)),   # SXM
    ("H100 PCIe", (51.2e12, 378e12, 756e12, 2.0e12)),
    ("H100 NVL", (60e12, 417.5e12, 835.5e12, 3.9e12)),
]


def peaks_for_name(name: str):
    """``{"fp32", "tf32", "bf16", "hbm_bytes_per_s"}`` for a card name, or
    None for a name the table does not hold."""
    for sub, (fp32, tf32, bf16, bw) in _PEAKS:
        if sub in name:
            return {"fp32": fp32, "tf32": tf32, "bf16": bf16, "hbm_bytes_per_s": bw}
    return None


def _peak(device, key):
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    p = peaks_for_name(torch.cuda.get_device_name(device))
    return p[key] if p else None


def peak_flops(device=None) -> float | None:
    """The card's dense TF32 tensor-core peak FLOP/s (the ``mfu``
    denominator), or None on the CPU or an unknown card."""
    return _peak(device, "tf32")


def peak_flops_fp32(device=None) -> float | None:
    """The card's dense float32 peak outside the tensor cores, or None."""
    return _peak(device, "fp32")


def hbm_bandwidth(device=None) -> float | None:
    """The card's HBM bytes/s, or None."""
    return _peak(device, "hbm_bytes_per_s")


def power_limit(device=None) -> str | None:
    """``name, power.limit`` as ``nvidia-smi`` gives them, or None without
    a card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    idx = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0]


def op_cost(fn, *args) -> dict:
    """FLOPs of ``fn(*args)`` as ``FlopCounterMode`` counts them: the aten
    matmuls, convolutions and attention that ran (the backward too, when
    ``fn`` takes a gradient).  The hand-written kernels count as zero, the
    undercount XLA's cost analysis has for custom calls, so this is a
    lower bound.  It counts no bytes.  ``fn`` runs once."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    with mode:
        fn(*args)
    return {"flops": float(mode.get_total_flops())}


# ---- analytic FLOP model ---------------------------------------------------

_flop_acc = None
_paused = 0


def _in_backward() -> bool:
    """Whether autograd's engine is running a backward: under
    ``torch.utils.checkpoint`` the backward runs the forward again, and its
    hooks must not count a second time (JAX's remat re-runs no Python)."""
    return torch._C._current_graph_task_id() != -1


def count_flops(matmul=0.0, elementwise=0.0):
    """Record forward model FLOPs of the op being run (a no-op unless an
    ``analytic_flops`` count is active, in a backward, or paused)."""
    if _flop_acc is None or _paused or _in_backward():
        return
    _flop_acc["matmul_fwd"] += float(matmul)
    _flop_acc["elementwise_fwd"] += float(elementwise)


def counting_active() -> bool:
    return _flop_acc is not None and not _paused and not _in_backward()


@contextlib.contextmanager
def paused():
    """Count nothing inside (an op whose count its caller made already)."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1


def analytic_flops(fn, args, grad=True) -> dict:
    """Analytic FLOPs of one call of ``fn(*args)`` from the op-level hooks.

    Torch has no ``eval_shape``: ``fn`` runs once, eagerly, with counting
    on, so it must be a function that runs its ops in Python, not a CUDA
    graph's replay (``train.scan_steps`` on the card), where no hook
    fires.  ``grad=True``: the program differentiates its hot path once
    (every ``train`` step does), so the total is 3x the forward count."""
    global _flop_acc
    prev, _flop_acc = _flop_acc, {"matmul_fwd": 0.0, "elementwise_fwd": 0.0}
    try:
        fn(*args)
        acc = _flop_acc
    finally:
        _flop_acc = prev
    mult = 3.0 if grad else 1.0
    total = mult * (acc["matmul_fwd"] + acc["elementwise_fwd"])
    return {
        "flops": total,
        "matmul_flops": mult * acc["matmul_fwd"],
        "elementwise_flops": mult * acc["elementwise_fwd"],
        "grad_multiplier": mult,
    }


def mfu_report(fn, args, step_time_s: float, steps_per_call: int = 1,
               device=None, grad=True) -> dict:
    """Utilisation summary for a timed step: FLOPs a step from both counts
    (``op_cost``, a lower bound, and ``analytic_flops``), and their shares
    of the card's peaks: ``mfu`` / ``mfu_analytic`` against TF32,
    ``fp32_share`` / ``fp32_share_analytic`` against float32.  ``fn`` runs
    twice (once a count).  ``step_time_s`` comes from the caller's own
    timing; ``steps_per_call`` divides the counts of a ``fn`` that runs
    several steps.  No byte count: ``op_cost`` gives none."""
    device = torch.device("cuda" if device is None else device)
    out = {"step_s": step_time_s,
           "device_kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else device.type),
           "power_limit": power_limit(device)}
    peak, peak32 = peak_flops(device), peak_flops_fp32(device)
    ana = analytic_flops(fn, args, grad=grad)
    out["flops_per_step_analytic"] = ana["flops"] / steps_per_call
    out["matmul_flops_per_step_analytic"] = ana["matmul_flops"] / steps_per_call
    out["elementwise_flops_per_step_analytic"] = ana["elementwise_flops"] / steps_per_call
    cost = op_cost(fn, *args)
    out["flops_per_step"] = cost["flops"] / steps_per_call
    out["peak_flops_per_s"] = peak
    out["peak_flops_fp32_per_s"] = peak32
    for key, flops in (("", out["flops_per_step"]),
                       ("_analytic", out["flops_per_step_analytic"])):
        ok = peak is not None and step_time_s > 0
        out["mfu" + key] = flops / step_time_s / peak if ok else None
        out["fp32_share" + key] = flops / step_time_s / peak32 if ok else None
    out["achieved_flops_per_s"] = (out["flops_per_step"] / step_time_s
                                   if step_time_s > 0 else None)
    return out
