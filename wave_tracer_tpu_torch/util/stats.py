"""Statistics collectors: counters, histograms, timings, running stats.

Port of wave_tracer_tpu/util/stats.py: a process-global host registry of
named collectors. The renderer records its device counters (rays, shadow
rays, interactions, traversal classes, the tris-per-cone histogram) here
after each backward render; `report()` gives them as a dict, and
`print_table` / `write_json` write them out.
"""

from __future__ import annotations

import json
import math
import time
from collections import defaultdict


class Counter:
    def __init__(self):
        self.value = 0

    def add(self, n=1):
        self.value += n

    def report(self):
        return self.value


class EventCounter:
    """N-bin event counter (e.g. ray casts: hit/miss/escaped)."""

    def __init__(self, bins):
        self.bins = list(bins)
        self.counts = defaultdict(int)

    def add(self, bin_name, n=1):
        self.counts[bin_name] += n

    def report(self):
        return dict(self.counts)


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


class Timing:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *a):
        self.total += time.time() - self._t0
        self.count += 1

    def report(self):
        return dict(total_s=self.total, count=self.count,
                    mean_s=self.total / max(self.count, 1))


class RunningStat:
    """Weighted mean/variance accumulator."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def add(self, x, w=1):
        self.n += w
        d = x - self.mean
        self.mean += d * w / self.n
        self.m2 += w * d * (x - self.mean)

    def report(self):
        var = self.m2 / max(self.n - 1, 1)
        return dict(n=self.n, mean=self.mean, std=math.sqrt(max(var, 0.0)))


class Registry:
    """Process-global named collector registry."""

    def __init__(self):
        self._collectors = {}

    def counter(self, name) -> Counter:
        return self._collectors.setdefault(name, Counter())

    def event_counter(self, name, bins=()) -> EventCounter:
        return self._collectors.setdefault(name, EventCounter(bins))

    def histogram(self, name, **kw) -> Histogram:
        return self._collectors.setdefault(name, Histogram(**kw))

    def timing(self, name) -> Timing:
        return self._collectors.setdefault(name, Timing())

    def running(self, name) -> RunningStat:
        return self._collectors.setdefault(name, RunningStat())

    def report(self) -> dict:
        return {k: c.report() for k, c in sorted(self._collectors.items())}

    def print_table(self, out=print):
        out(f"{'statistic':40s} value")
        out("-" * 60)
        for k, v in self.report().items():
            out(f"{k:40s} {v}")

    def write_json(self, path):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2, default=str)

    def reset(self):
        self._collectors.clear()


registry = Registry()
