"""k2_roofline: the K2 calls' floor (wtbench/roofline.py) over
their device time in the traced window, in percent."""

from wtbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k2")
