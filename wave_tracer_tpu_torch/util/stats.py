"""Statistics collectors and spans: the port's one registry.

Port of wave_tracer_tpu/util/stats.py: a process-global host registry of
named collectors, extended by spans.

Counters and histograms are always on and are host numbers. The renderer
folds its device counters (rays, shadow rays, interactions, traversal
classes, the tris-per-cone histogram) into `integrator/*` and
`ads/tris_per_cone` after each backward render; the lane pool counts
`pool/steps`, `pool/lane_slots` and `pool/drain_steps`; each kernel
wrapper counts its launches under `launches/k1` ... `launches/k5` (and
`launches/k3_winners`) through a handle it holds from import on, and the
cone sweep (`accel/trace.py::cone_boundary_minz`) the rows it gives K3
and those off its `need` (`k3/rows_swept`, `k3/rows_skipped`).

`span(name)` marks a stage of the program. A span is on exactly while a
torch.profiler profile records (`torch.autograd.profiler.
_is_profiler_enabled`); off, it is a shared no-op context and costs one
flag read. On, it opens `record_function(name)`, so the profiler's trace
holds it on the clock of the device activity, and records a pair of CUDA
events on the current stream (from a reused pool, without a wait). Its
stream time runs from the later of the stream finishing the work queued
before the span and the host entering it, to the later of the span's last
operation finishing and the host leaving it: the spans of one step
partition the step's stream time, and an idle stretch of the card falls
in the span the host was in. Without CUDA, stream time is host time. The
events are read once they have completed (at the exit of an outermost
span, without waiting) or by `report()`, which waits for them.

`report()` gives a dict: each counter's number, each histogram's bins,
and for each span name {count, host_s, stream_s, self_stream_s} (self:
minus the stream time of its child spans). `spans` keeps every span
recorded since the last `reset()`: name, parent, frame (the index of the
outermost span it ran under: a render's `wt.frame`), host start and end
(`perf_counter_ns`) and stream seconds.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch
import torch.autograd.profiler as _profiler


class Counter:
    def __init__(self):
        self.value = 0

    def add(self, n=1):
        self.value += n

    def report(self):
        return self.value

    def reset(self):
        self.value = 0


class Histogram:
    """Log-binned histogram (bin 0: values ≤ 0; bin b: base^(b-1) ≤ v)."""

    def __init__(self, n_bins=24, base=2.0):
        self.n_bins = n_bins
        self.base = base
        self.counts = [0] * n_bins

    def add(self, value, n=1):
        if value <= 0:
            b = 0
        else:
            b = min(int(math.log(value, self.base)) + 1, self.n_bins - 1)
        self.counts[b] += n

    def add_count(self, bin_idx, n=1):
        """Accumulate directly into a bin (device-side histograms hand
        back already-binned counts)."""
        b = min(max(int(bin_idx), 0), self.n_bins - 1)
        self.counts[b] += n

    def report(self):
        return list(self.counts)

    def reset(self):
        self.counts = [0] * self.n_bins


class SpanTotals:
    """Count, host seconds, stream seconds and self stream seconds of the
    spans of one name."""

    def __init__(self):
        self.reset()

    def report(self):
        return dict(count=self.count, host_s=self.host_s,
                    stream_s=self.stream_s, self_stream_s=self.self_s)

    def reset(self):
        self.count = 0
        self.host_s = self.stream_s = self.self_s = 0.0


class Span:
    """One recorded span; a context manager while it is open."""

    __slots__ = ("reg", "name", "parent", "frame", "host0", "host1",
                 "stream_s", "_rf", "_ev0", "_ev1")

    def __init__(self, reg, name):
        self.reg, self.name = reg, name
        self.host1 = self.stream_s = self._ev0 = self._ev1 = None

    def __enter__(self):
        reg = self.reg
        self.parent = reg._open[-1] if reg._open else None
        if self.parent is None:
            reg._roots += 1
        self.frame = reg._roots - 1
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        self.host0 = time.perf_counter_ns()
        if torch.cuda.is_initialized():
            self._ev0 = reg._event()
        reg._open.append(self)
        reg.spans.append(self)
        return self

    def __exit__(self, *exc):
        reg = self.reg
        if self._ev0 is not None:
            self._ev1 = reg._event()
        self.host1 = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        reg._open.pop()
        reg._pending.append(self)
        if self.parent is None:
            reg._fold(wait=False)
        return False


class Registry:
    """Process-global named collector registry."""

    def __init__(self):
        self._collectors = {}
        self.spans = []
        self._open = []          # the spans open now, innermost last
        self._pending = []       # closed spans whose stream time is unread
        self._free = []          # CUDA events to reuse
        self._roots = 0

    def _get(self, name, kind):
        c = self._collectors.get(name)
        if c is None:
            c = self._collectors[name] = kind()
        return c

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name) -> Histogram:
        return self._get(name, Histogram)

    def _event(self):
        """A timing CUDA event from the pool, recorded on the current
        stream."""
        ev = self._free.pop() if self._free else \
            torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _fold(self, wait):
        """Add the closed spans to their names' totals, those whose end
        event has completed (every one with `wait`)."""
        keep = []
        for s in self._pending:
            if s._ev1 is None:
                s.stream_s = (s.host1 - s.host0) * 1e-9
            elif wait or s._ev1.query():
                s._ev1.synchronize()
                s.stream_s = s._ev0.elapsed_time(s._ev1) * 1e-3
                self._free += (s._ev0, s._ev1)
                s._ev0 = s._ev1 = None
            else:
                keep.append(s)
                continue
            t = self._get(s.name, SpanTotals)
            t.count += 1
            t.host_s += (s.host1 - s.host0) * 1e-9
            t.stream_s += s.stream_s
            t.self_s += s.stream_s
            if s.parent is not None:
                self._get(s.parent.name, SpanTotals).self_s -= s.stream_s
        self._pending = keep

    def report(self) -> dict:
        self._fold(wait=True)
        return {k: c.report() for k, c in sorted(self._collectors.items())}

    def reset(self):
        """Zero every collector (the handles callers hold stay live) and
        drop the recorded spans."""
        self._fold(wait=True)
        for c in self._collectors.values():
            c.reset()
        self.spans.clear()


registry = Registry()

_OFF = contextlib.nullcontext()


def span(name):
    """A span of the program's stage `name` in the registry; a shared
    no-op context unless a torch.profiler profile records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(registry, name)
