"""Hybrid ballistic/diffusive traversal — closed-form segment schedule.

Port of wave_tracer_tpu/integrator/traversal.py (`segment_boundaries`,
`schedule`, `schedule_from_minz`, `region_depth`). Per path the reference alternates
ballistic segments of B_j = min(8·2^(2j+1), 65536) wavelengths with
diffusive full-cone attempts at each segment boundary. The boundaries
d_j = Σ B_i·λ depend only on λ, so the schedule is per-lane masked
arithmetic over one ray trace and the per-boundary earliest cone
encounters: those of `accel.trace.cone_boundary_minz` (K3), or the
earliest of a K-capped encounter list (`schedule`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BIG = 1e30
MAX_SEGMENTS = 16
SEG_LAMBDAS = 8
MAX_SEG_LAMBDAS = 1 << 16
# z-extent of the interaction region relative to the major axis
Z_SCALE = 2.0

_B = [min(SEG_LAMBDAS << (2 * j + 1), MAX_SEG_LAMBDAS)
      for j in range(MAX_SEGMENTS)]
_CUM = [float(sum(_B[:j + 1])) for j in range(MAX_SEGMENTS)]


def segment_boundaries(lam):
    """Cumulative ballistic boundaries d_1..d_16 per lane: lam (N,)
    wavelength in metres → (N, 16) f32."""
    cum = torch.tensor(_CUM, dtype=torch.float32, device=lam.device)
    return lam[:, None] * cum[None, :]


@dataclass
class TraversalResult:
    ballistic: torch.Tensor  # (N,) bool — interaction from a ray hit
    diffusive: torch.Tensor  # (N,) bool — interaction from a cone region
    z_region: torch.Tensor   # (N,) region start (diffusive) / hit z
    escaped: torch.Tensor    # (N,) bool — no interaction within dist_max


def schedule(t_ray, ray_hit, tz, env, lam, dist_max,
             tol_scale: float = 1e-3):
    """The ballistic/diffusive schedule from a K-capped encounter list: tz
    (N, K) ascending exact cone–triangle entry distances, inf-padded (the
    set queries of accel/trace.py under WT_CONE_QUERY). The earliest
    encounter ≥ each boundary takes the place of `schedule_from_minz`'s
    zc column; the rule is the same. tol_scale is unused, as in the JAX
    package."""
    bounds = segment_boundaries(lam)
    zc = torch.stack([torch.where(tz >= bounds[:, j:j + 1], tz,
                                  torch.inf).amin(1)
                      for j in range(MAX_SEGMENTS)], dim=1)
    return schedule_from_minz(t_ray, ray_hit, zc, env, lam, dist_max)


def schedule_from_minz(t_ray, ray_hit, zc, env, lam, dist_max):
    """The ballistic/diffusive schedule from per-boundary earliest
    encounters zc (N, 16) (inf = none ahead). Per boundary d: ballistic
    wins when the ray hit falls before d; otherwise the earliest encounter
    zc ≥ d is a diffusive region iff zc − d ≥ major(d)/2, zc ≤ t_ray and
    zc < dist_max; no encounter ahead and no ray hit means escape."""
    N = t_ray.shape[0]
    dev = t_ray.device
    bounds = segment_boundaries(lam)
    t_eff = torch.where(ray_hit, t_ray, BIG)

    def false():
        return torch.zeros((N,), dtype=torch.bool, device=dev)

    decided, ballistic, diffusive, escaped = false(), false(), false(), \
        false()
    z_region = torch.where(ray_hit, t_eff, 0.0)
    for j in range(MAX_SEGMENTS):
        d = bounds[:, j]
        b_now = ~decided & (t_eff <= d)
        ballistic = ballistic | b_now
        decided = decided | b_now
        zcj = zc[:, j]
        finite = torch.isfinite(zcj)
        ok = finite & (zcj - d >= 0.5 * env.major(d)) & (zcj <= t_eff) \
            & (zcj < dist_max)
        e_now = ~decided & ~finite & (t_eff >= BIG)
        d_now = ~decided & ok
        escaped = escaped | e_now
        diffusive = diffusive | d_now
        z_region = torch.where(d_now, zcj, z_region)
        decided = decided | e_now | d_now

    # final unbounded ballistic segment
    b_fin = ~decided & ray_hit & (t_eff < dist_max)
    ballistic = ballistic | b_fin
    escaped = escaped | (~decided & ~b_fin)
    z_region = torch.where(ballistic, t_eff, z_region)
    return TraversalResult(ballistic=ballistic, diffusive=diffusive,
                           z_region=z_region, escaped=escaped)


def region_depth(env, z):
    """Interaction-region z-depth at distance z: Z_SCALE × major axis."""
    return Z_SCALE * env.major(z)
