"""Beam phase-space geometry: SBP and minimum-uncertainty beams.

Port of the MUB functions of wave_tracer_tpu/wave/beam.py: the
space-bandwidth product with a 3σ cross-section envelope and the SBP ≥ ¼
uncertainty bound. Elementwise torch over lane batches; wavenumbers in
rad/m.
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
