"""Beam phase-space geometry: SBP, minimum-uncertainty beams, wavefronts.

Port of wave_tracer_tpu/wave/beam.py: the space-bandwidth product with a
3σ cross-section envelope, the SBP ≥ ¼ uncertainty bound, the Gaussian
cross-section (wavefront) helpers and the beam footprints. Elementwise
torch over lane batches; wavenumbers in rad/m.
"""

from __future__ import annotations

import math

import torch

# beam cross-section envelope = 3σ
ENVELOPE = 3.0
MUB_SBP = 0.25


def sbp(spatial_extent, tan_alpha, k):
    """Space-bandwidth product: (σ_area)·(k·tanα/3)²."""
    area_std = spatial_extent / (ENVELOPE ** 2)
    wv_std = (k * tan_alpha / ENVELOPE) ** 2
    return area_std * wv_std


def is_mub(spatial_extent, tan_alpha, k, tol=3e-7):
    return sbp(spatial_extent, tan_alpha, k) >= MUB_SBP - tol


def minimum_uncertainty_tan_alpha(spatial_extent, k):
    """tanα of a MUB with the given spatial extent (area)."""
    ta = torch.sqrt(MUB_SBP / spatial_extent.clamp_min(1e-30)) \
        * ENVELOPE ** 2 / k.clamp_min(1e-30)
    return torch.where(spatial_extent > 0, ta, 0.0)


def minimum_uncertainty_spatial_extent(tan_alpha, k):
    """Spatial extent (area) of a MUB with the given tanα."""
    ln = math.sqrt(MUB_SBP) * ENVELOPE ** 2 \
        / (k * tan_alpha).clamp_min(1e-30)
    return torch.where(tan_alpha > 0, ln * ln, 0.0)


def make_mub(spatial_extent, tan_alpha, k):
    """Enlarge a phase-space extent to satisfy SBP ≥ ¼. Returns
    (spatial_extent, tan_alpha)."""
    s = sbp(spatial_extent, tan_alpha, k)
    zero_sbp = s <= 0.0
    se_fill = torch.where(tan_alpha > 0,
                          minimum_uncertainty_spatial_extent(tan_alpha, k),
                          spatial_extent)
    ta_fill = torch.where(tan_alpha > 0, tan_alpha,
                          minimum_uncertainty_tan_alpha(spatial_extent, k))
    scale = torch.sqrt(torch.sqrt(MUB_SBP / s.clamp_min(1e-30)))
    scale = scale.clamp_min(1.0)
    se = torch.where(zero_sbp, se_fill, spatial_extent * scale ** 2)
    ta = torch.where(zero_sbp, ta_fill, tan_alpha * scale)
    return se, ta


# ---------------------------------------------------------------------------
# Gaussian wavefront (cross-section intensity) and footprints
# ---------------------------------------------------------------------------

def wavefront_sigma(major, minor):
    """σ of the Gaussian cross-section given its envelope (3σ) axes."""
    return major / ENVELOPE, minor / ENVELOPE


def wavefront_amplitude(sx, sy):
    """Normalization 1/(2π σx σy) of the 2D Gaussian."""
    return 1.0 / (2.0 * math.pi * sx * sy).clamp_min(1e-30)


def wavefront_density(p2, sx, sy):
    """2D Gaussian density at cross-section points p2 (..., 2)."""
    q = (p2[..., 0] / sx.clamp_min(1e-30)) ** 2 \
        + (p2[..., 1] / sy.clamp_min(1e-30)) ** 2
    return wavefront_amplitude(sx, sy) * torch.exp(-0.5 * q)


def wavefront_mass_in_radius(r, sx, sy):
    """Mass of the isotropized Gaussian (σ = √(σx σy)) within radius r."""
    s2 = (sx * sy).clamp_min(1e-30)
    return 1.0 - torch.exp(-0.5 * r * r / s2)


def beam_footprint_axes(cone, z):
    """Envelope ellipse axes (major, minor) at distance z along the beam."""
    return cone.axes(z)


def surface_footprint_ellipse(cone, z, d, n, t_dir=None):
    """The beam cross-section at distance z projected along d onto the
    plane with normal n: (a_world, b_world) (..., 3) footprint axes (not
    necessarily orthogonal). t_dir is unused, as in the JAX package."""
    major, minor = cone.axes(z)
    ax_w = cone.x * major[..., None]
    by_w = cone.y * minor[..., None]
    nd = (n * d).sum(-1, keepdim=True)
    nd = torch.where(nd.abs() < 1e-6, torch.sign(nd) * 1e-6 + 1e-12, nd)

    def proj(v):
        return v - d * ((n * v).sum(-1, keepdim=True) / nd)
    return proj(ax_w), proj(by_w)
