"""launches_per_kbeam: CUDA kernel launches in the traced window (the
device trace) per 1,000 beams completed in it."""

from wtbench.readers import launches_per_k


def read(ctx):
    return launches_per_k(ctx)
