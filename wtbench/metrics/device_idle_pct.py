"""device_idle_pct: the share of the traced window in which no
operation ran on the card (the union of the device trace's intervals),
in percent."""

from wtbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
