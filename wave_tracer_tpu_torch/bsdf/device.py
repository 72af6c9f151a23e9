"""Device BSDF dispatch: batched sample / eval over the material table.

Port of wave_tracer_tpu/bsdf/device.py for the diffuse and null lobes,
including the `twosided` back-face flip. Directions are in the local
shading frame (z = shading normal), pointing away from the surface:
* `eval_f` returns the Mueller-valued BSDF including the |wo.z| cosine;
* `sample` returns wo, its density and the weighted bsdf Mw = M/pdf.
Dispatch is compute-all-select by material type. Dielectric and
surface_spm rows never reach here: baking or bridging them raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from wave_tracer_tpu_torch.bsdf.table import (C_MTYPE, C_REFL_TEX, C_SCALE,
                                              C_TWOSIDED, MT_DIFFUSE,
                                              MT_NULL, MaterialTable)
from wave_tracer_tpu_torch.polarization import mueller
from wave_tracer_tpu_torch.sampling import warps
from wave_tracer_tpu_torch.spectrum.bake import SpectrumTable
from wave_tracer_tpu_torch.texture.texture import (TextureTable,
                                                   eval_texture_scalar)

INV_PI = 1.0 / math.pi


@dataclass
class Tables:
    """All device lookup tables needed for material evaluation."""
    materials: MaterialTable
    textures: TextureTable
    spectra: SpectrumTable


@dataclass
class BsdfSample:
    wo: torch.Tensor         # (N, 3) local
    pdf: torch.Tensor        # (N,)
    Mw: torch.Tensor         # (N, 4, 4) weighted bsdf M/pdf
    specular: torch.Tensor   # (N,) bool — discrete (delta) lobe
    eta: torch.Tensor        # (N,) real oriented η ratio (1: no refraction)
    refracted: torch.Tensor  # (N,) bool
    valid: torch.Tensor      # (N,) bool


def _row_and_frame(tables: Tables, mat_id, wi):
    """Material row, effective type and the twosided sign flip."""
    row = tables.materials.pack[mat_id.clamp_min(0).long()]
    mtype = torch.where(mat_id >= 0, row[:, C_MTYPE].to(torch.int32),
                        torch.full_like(mat_id, MT_NULL, dtype=torch.int32))
    flip = (row[:, C_TWOSIDED] > 0.5) & (wi[..., 2] < 0.0)
    sgn = torch.where(flip, -1.0, 1.0).to(wi.dtype)
    return row, mtype, sgn


def _flip_z(w, sgn):
    return torch.cat([w[..., :2], (w[..., 2] * sgn)[..., None]], dim=-1)


def _reflectance(tables, row, uv, k):
    return eval_texture_scalar(tables.textures, tables.spectra,
                               row[:, C_REFL_TEX].to(torch.int32), uv,
                               k).clamp(0.0, 1.0)


def sample(tables: Tables, mat_id, wi, uv, k, u4):
    """Sample all lanes' BSDFs. u4 (N, 4) uniforms. Returns BsdfSample."""
    row, mtype, sgn = _row_and_frame(tables, mat_id, wi)
    wi_l = _flip_z(wi, sgn)
    scale = row[:, C_SCALE]

    # diffuse
    refl = _reflectance(tables, row, uv, k)
    wo_d = warps.cosine_hemisphere(u4[..., 2:4])
    pdf_d = warps.cosine_hemisphere_pdf(wo_d[..., 2])
    Mw_d = mueller.depolarizer(refl * scale)
    valid_d = wi_l[..., 2] > 0.0

    # null (passthrough)
    wo_null = -wi_l
    Mw_null = mueller.identity(wi_l.shape[:-1], device=wi.device)

    is_d = mtype == MT_DIFFUSE
    wo = torch.where(is_d[..., None], wo_d, wo_null)
    Mw = torch.where(is_d[..., None, None], Mw_d, Mw_null)
    pdf = torch.where(is_d, pdf_d, torch.ones_like(pdf_d))
    valid = torch.where(is_d, valid_d, mat_id >= 0)
    wo = _flip_z(wo, sgn)
    return BsdfSample(wo=wo, pdf=pdf, Mw=Mw, specular=~is_d,
                      eta=torch.ones_like(pdf),
                      refracted=torch.zeros_like(valid), valid=valid)


@dataclass
class MaterialAt:
    """What `eval_f` reads of a material at one surface point and
    wavenumber, whatever the directions: formed once by `material_at` for
    a vertex that many directions are evaluated at."""
    row: torch.Tensor        # (N, C) material row
    mtype: torch.Tensor      # (N,) i32 effective type
    refl: torch.Tensor       # (N,) diffuse reflectance at (uv, k)


def material_at(tables: Tables, mat_id, uv, k) -> MaterialAt:
    row = tables.materials.pack[mat_id.clamp_min(0).long()]
    mtype = torch.where(mat_id >= 0, row[:, C_MTYPE].to(torch.int32),
                        torch.full_like(mat_id, MT_NULL, dtype=torch.int32))
    return MaterialAt(row=row, mtype=mtype,
                      refl=_reflectance(tables, row, uv, k))


def eval_f(tables: Tables, mat_id, wi, wo, uv, k, at: MaterialAt = None):
    """Evaluate the non-delta lobes: returns (M (N,4,4), pdf (N,)). M
    includes the |wo.z| cosine; pdf is the density `sample` would have for
    (wi → wo), for MIS. The null lobe is a delta: M = 0, pdf = 0. `at`:
    the material at (mat_id, uv, k) from `material_at`, if formed."""
    if at is None:
        at = material_at(tables, mat_id, uv, k)
    row, mtype, refl = at.row, at.mtype, at.refl
    flip = (row[:, C_TWOSIDED] > 0.5) & (wi[..., 2] < 0.0)
    sgn = torch.where(flip, -1.0, 1.0).to(wi.dtype)
    wi_l = _flip_z(wi, sgn)
    wo_l = _flip_z(wo, sgn)
    scale = row[:, C_SCALE]
    both_up = (wi_l[..., 2] > 0) & (wo_l[..., 2] > 0) & (mtype == MT_DIFFUSE)
    zero = torch.zeros_like(refl)
    f_d = torch.where(both_up, wo_l[..., 2] * INV_PI * refl * scale, zero)
    pdf = torch.where(both_up, warps.cosine_hemisphere_pdf(wo_l[..., 2]),
                      zero)
    return mueller.depolarizer(f_d), pdf


def apply_normalmap(tables: Tables, mat_id, uv, k, sf):
    """Normal maps are not ported yet (baking one raises), so the shading
    frame passes through unchanged."""
    return sf
