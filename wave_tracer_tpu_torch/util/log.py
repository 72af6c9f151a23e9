"""Leveled logger for the CLI.

Port of wave_tracer_tpu/util/log.py (standard library only): the
verbosity levels, a logger that prints a prefixed line at or below its
level, and a named inline progress bar. The CLI logs at QUIET on every
rank of a distributed render but rank 0, so only rank 0 prints its lines.
"""

from __future__ import annotations

import sys
import time
from enum import IntEnum


class Verbosity(IntEnum):
    QUIET = 0
    IMPORTANT = 1
    NORMAL = 2
    INFO = 3
    DEBUG = 4


class Logger:
    def __init__(self, verbosity: Verbosity = Verbosity.NORMAL,
                 prefix: str = ""):
        self.verbosity = verbosity
        self.prefix = prefix

    def log(self, level: Verbosity, msg: str):
        if level <= self.verbosity:
            print(self.prefix + msg)

    def __call__(self, msg):
        self.log(Verbosity.NORMAL, msg)


class ProgressBar:
    """Named inline progress bar: redrawn on `update(done)` when the
    fraction moved by 1% or finished, with the elapsed time and an ETA."""

    def __init__(self, name: str, total: int, width: int = 36,
                 stream=None):
        self.name = name
        self.total = max(total, 1)
        self.width = width
        self.stream = sys.stdout if stream is None else stream
        self.start = time.time()
        self._last = -1.0

    def update(self, done: int):
        frac = min(done / self.total, 1.0)
        if frac - self._last < 0.01 and frac < 1.0:
            return
        self._last = frac
        filled = int(self.width * frac)
        bar = "█" * filled + "·" * (self.width - filled)
        dt = time.time() - self.start
        eta = dt / max(frac, 1e-9) * (1 - frac)
        self.stream.write(f"\r{self.name:>12} [{bar}] "
                          f"{100 * frac:5.1f}%  {dt:6.1f}s"
                          + (f"  eta {eta:5.1f}s" if frac < 1 else " " * 12))
        self.stream.flush()
        if frac >= 1.0:
            self.stream.write("\n")
