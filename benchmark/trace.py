"""Reduction of a ``torch.profiler`` trace of the traced window: the
device's busy time (the union of its kernels', copies' and memsets'
intervals), the device time of each kernel name, and the longest idle
gaps named by what the host was doing in them.

The traced window runs from the start of the first device activity to
the end of the last inside the host annotation ``WINDOW`` that the harness
records around the traced steps: the host's first launch and its final
synchronise, which no steady run pays, are left out.
"""
from __future__ import annotations

WINDOW = "bench.traced_window"


def _union(spans):
    """Sorted, merged intervals of ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(prof):
    """``{"window_s", "busy_s", "kernels": {name: s}, "idle_gaps":
    [[name, s], ...]}`` of a finished profiler, or None where the trace
    holds no window or no device activity in it."""
    from torch.autograd import DeviceType
    events = prof.events()
    windows = [e for e in events if e.name == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b, e.name))
        elif e.name != WINDOW and b > w0 and a < w1:
            host.append((a, b, e.name))
    if not device:
        return None
    w0, w1 = min(a for a, _, _ in device), max(b for _, b, _ in device)
    host = [h for h in host if h[1] > w0 and h[0] < w1]
    kernels = {}
    for a, b, name in device:
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e6
    busy = _union([(a, b) for a, b, _ in device])
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    named = []
    for a, b in gaps:
        covering = [h for h in host if h[0] <= a < h[1]]
        what = max(covering, key=lambda h: h[0])[2] if covering else "host_idle"
        named.append([f"{what}@{(a - w0) / 1e6:.4f}s", (b - a) / 1e6])
    named.sort(key=lambda g: -g[1])
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernels": kernels,
            "idle_gaps": named[:10]}


def top_kernels(summary, n=10):
    """The ``n`` kernel names that took the most device time, as
    ``[[name, s], ...]``."""
    ranked = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])
    return [[name[:160], s] for name, s in ranked[:n]]


def kernel_seconds(summary, fragment):
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(s for name, s in summary["kernels"].items() if fragment in name)
