"""pool_overhead_pct: the share of the traced window's frames that the
lane pool's own work takes, in percent: the stream seconds of the
program's `wt.pool.splat`, `wt.pool.refill` (with its host sync) and
`wt.pool.poll` spans over those of its `wt.frame` spans."""

from wtbench.program_stats import stream_pct


def read(ctx):
    return stream_pct(["wt.pool.splat", "wt.pool.refill", "wt.pool.poll"])
