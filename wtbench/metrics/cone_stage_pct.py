"""cone_stage_pct: the share of the traced window's frames that the
bounce's cone stage takes, in percent: the stream seconds of the
program's `wt.bounce.cones` spans (segment boundaries, K3, the schedule)
over those of its `wt.frame` spans. The ceiling on what a change to K3
can give end to end."""

from wtbench.program_stats import stream_pct


def read(ctx):
    return stream_pct(["wt.bounce.cones"])
