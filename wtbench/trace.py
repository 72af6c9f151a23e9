"""Reduction of a torch.profiler trace of the traced window to what the
per-layer metrics read: device time by kernel name, kernel launches, the
device's busy time (the union of every device operation's interval) and
window, the operations that took the most device time, and the longest
idle gaps with the host operation that was running when each began.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

WINDOW = "wtbench.window"


def _is_device(e):
    """An operation that ran on the card (not a span's device-side
    annotation)."""
    if e.is_user_annotation():
        return False
    return "cuda" in str(e.device_type()).lower()


def _is_kernel(name):
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def reduce(prof):
    """→ dict: window_s, busy_s, launches, kernels {name: [count, s]},
    device_ops [[name, s]] (top 10), idle_gaps [[host op, s]] (top 10)."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW
           and "cpu" in str(e.device_type()).lower()]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t < w0 or s > w1:
            continue
        if e.name() == WINDOW:
            continue
        if _is_device(e):
            name = e.name()
            dev.append((max(s, w0), min(t, w1)))
            if _is_kernel(name):
                k = kernels[name]
                k[0] += 1
                k[1] += (t - s) * 1e-9
        elif "cpu" in str(e.device_type()).lower():
            host.append((s, t, e.name()))
    dev.sort()
    busy = 0
    gaps = []
    cursor = w0
    for s, t in dev:
        if s > cursor:
            gaps.append((s - cursor, cursor))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps.append((w1 - cursor, cursor))
    gaps.sort(reverse=True)
    hs = np.array([h[0] for h in host], np.int64)
    he = np.array([h[1] for h in host], np.int64)
    idle = []
    for length, at in gaps[:10]:
        inside = np.flatnonzero((hs <= at) & (he > at))
        if len(inside):
            name = host[inside[np.argmin(he[inside] - hs[inside])]][2]
        else:
            name = "(no host op)"
        idle.append([name, length * 1e-9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                launches=sum(k[0] for k in kernels.values()),
                kernels={k: v for k, v in kernels.items()},
                device_ops=[[name[:160], v[1]] for name, v in top],
                idle_gaps=idle)


def kernel_seconds(summary, pattern):
    """Device seconds of the kernels whose name contains `pattern`."""
    return sum(v[1] for k, v in summary["kernels"].items() if pattern in k)
