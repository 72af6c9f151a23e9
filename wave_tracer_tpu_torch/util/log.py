"""Leveled logger for the CLI.

The part of wave_tracer_tpu/util/log.py that the CLI uses (standard
library only): the verbosity levels and a logger that prints a prefixed
line at or below its level. The CLI logs at QUIET on every rank of a
distributed render but rank 0, so only rank 0 prints its lines.
"""

from __future__ import annotations

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
