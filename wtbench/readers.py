"""Shared arithmetic of the metric readers (wtbench/metrics/<name>.py).

A reader gets the run's context: setup_s, bake_s, window_s, frames,
work_per_frame (paths or beams a frame), memory_peak_bytes, calls (the
kernel calls' rows and triangles, traced runs only) and, in a traced
run, trace (wtbench/trace.py's summary of the traced window). It returns
a number, or None where it finds nothing to read.
"""

from __future__ import annotations

from wtbench import roofline
from wtbench.trace import kernel_seconds


def rate(ctx):
    """Work of the completed frames over the whole window's seconds."""
    return ctx["frames"] * ctx["work_per_frame"] / ctx["window_s"]


def launches_per_k(ctx):
    """Kernel launches of the traced window per 1,000 paths (or beams)."""
    t = ctx.get("trace")
    if not t or not t["launches"]:
        return None
    return t["launches"] / (ctx["frames"] * ctx["work_per_frame"] / 1000.0)


def roofline_pct(ctx, kind):
    """The summed floors of a kernel's calls over its summed device time,
    in percent; None where the window has no such call."""
    t = ctx.get("trace")
    calls = ctx.get("calls", {}).get(kind)
    if not t or not calls:
        return None
    secs = kernel_seconds(t, roofline.KERNEL_NAMES[kind])
    if secs <= 0:
        return None
    return 100.0 * roofline.floor_seconds(kind, calls) / secs


def idle_pct(ctx):
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    t = ctx.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
