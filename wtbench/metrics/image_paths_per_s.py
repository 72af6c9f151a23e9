"""image_paths_per_s: camera paths of the window's completed frames over
the window's seconds (host clock): how fast a wave-optical image
converges."""

from wtbench.readers import rate


def read(ctx):
    return rate(ctx)
