"""Tracing and timing helpers (counterpart of ``alan_tpu/profiling.py``).

* :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome / TensorBoard trace, with the card's kernels where the work
  runs on the card;
* :func:`timed_steps` -- per-step wall-clock with the step's device
  synchronised after every step (the reference's ``iter_times``);
* :func:`device_memory_stats` -- the allocator's statistics of each
  visible card (the reference's max-allocated report);
* :func:`device_busy` -- the card's busy time under a call (the union of
  its kernels' and copies' intervals, from ``torch.profiler``).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its trace to ``logdir/trace.json``
    (``chrome://tracing``, Perfetto or TensorBoard read it), the card's
    activity too where a card is present.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync_for(out):
    """Synchronise the card that ``out``'s first tensor lies on; nothing
    for the CPU."""
    def first(x):
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            for v in x:
                t = first(v)
                if t is not None:
                    return t
        data = getattr(x, "data", None)
        return data if isinstance(data, torch.Tensor) else None
    t = first(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def timed_steps(step, state, generators, sync=_sync_for):
    """Run ``state, out = step(state, generator)`` over ``generators``;
    returns ``(state, outs, iter_times)``, each time taken after
    ``sync(out)`` (by default a synchronise of the card the output lies
    on)."""
    outs, times = [], []
    for g in generators:
        t0 = time.perf_counter()
        state, out = step(state, g)
        sync(out)
        times.append(time.perf_counter() - t0)
        outs.append(out)
    return state, outs, times


def device_memory_stats():
    """``{device: torch.cuda.memory_stats(device)}`` for each visible card,
    ``{"cpu": None}`` without one: the host has no allocator statistics."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    stats = {}
    for i in range(torch.cuda.device_count()):
        try:
            stats[f"cuda:{i}"] = torch.cuda.memory_stats(i)
        except RuntimeError:
            stats[f"cuda:{i}"] = None
    return stats


def device_busy(fn, device):
    """``(fn(), busy seconds)``: the union of the intervals in which the
    card ``device`` ran anything (kernels, copies, memsets) during the call,
    read from ``torch.profiler``; ``(fn(), None)`` on the CPU, which has no
    device timeline.  The profiler slows the host, so time the call apart
    to set the busy time against its wall time."""
    device = torch.device(device)
    if device.type != "cuda":
        return fn(), None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize(device)
    # operators' names are put on the device timeline too: count only the
    # device's own activity, not those annotations
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return out, busy_us / 1e6
