"""pool_occupancy: the share of the lane pool's slots that held a live
lane at a bounce, in percent: 100 × the program's `integrator/rays_cast`
(live lanes bounced) over `pool/lane_slots` (the pool's width, once a
step), over set-up's warm frame and the window alike. It is also the
share of K3's rows that are live: K3 sweeps every row of the pool."""

from wtbench.program_stats import report


def read(ctx):
    rep = report()
    slots = rep.get("pool/lane_slots")
    if not slots:
        return None
    return 100.0 * rep.get("integrator/rays_cast", 0.0) / slots
