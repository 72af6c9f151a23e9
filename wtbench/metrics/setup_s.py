"""setup_s: process start to the first timed frame (host clock): imports,
the kernels' load (their build in a checkout's first run), the scene bake
and one warm frame at the cell's own shapes."""


def read(ctx):
    return ctx["setup_s"]
