"""k1_roofline: the K1 calls' floor (wtbench/roofline.py) over
their device time in the traced window, in percent."""

from wtbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k1")
