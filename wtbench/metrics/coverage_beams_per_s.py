"""coverage_beams_per_s: emitted beams (elements × samples) of the
window's completed coverage maps over the window's seconds (host clock):
how fast a coverage map converges."""

from wtbench.readers import rate


def read(ctx):
    return rate(ctx)
