"""Device material table: packed rows for branch-free dispatch.

Port of wave_tracer_tpu/bsdf/table.py. The bake keeps the JAX package's
(M, 16) pack layout and its composite-bin tables (child row, kmin, kmax
per bin), so tables baked by either package load through the same
bridge. Diffuse, dielectric, surface_spm, composite and null rows bake
here, with their opacity-mask and normal-map texture columns.

The table records which features its rows use (`has_spm`,
`has_dielectric`, `has_mask`, `has_normalmap`, `has_composite`): the BSDF
dispatch forms no term that no row selects, so a table of diffuse rows
costs what it did before the other lobes were ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.bsdf import model, profiles

MT_DIFFUSE = 0
MT_DIELECTRIC = 1
MT_SPM = 2
MT_NULL = 3

MAX_COMPOSITE_BINS = 4

# pack column indices (the JAX MaterialTable layout)
(C_MTYPE, C_TWOSIDED, C_SCALE, C_REFL_TEX, C_OPACITY_TEX,
 C_NORMALMAP_TEX, C_IOR, C_EXT_IOR, C_RSCALE, C_TSCALE, C_PROF_TYPE,
 C_PROF_GAMMA, C_PROF_ROUGH_TEX, C_PROF_T, C_PROF_SIGMAH) = range(15)


@dataclass
class MaterialTable:
    pack: torch.Tensor        # (M, 16) all scalar fields as f32
    comp_child: torch.Tensor  # (M, B) i32 composite children (-1 unused)
    comp_kmin: torch.Tensor   # (M, B) f32
    comp_kmax: torch.Tensor   # (M, B) f32
    # the features the rows use (host-known)
    has_spm: bool = False
    has_dielectric: bool = False
    has_mask: bool = False
    has_normalmap: bool = False
    has_composite: bool = False

    @property
    def count(self):
        return self.pack.shape[0]

    def resolve(self, mat_id, k):
        """The row a material id stands for at wavenumber k: a composite
        row's child in the first bin [kmin, kmax) that holds k, the row
        itself outside every bin; negative ids pass through."""
        if not self.has_composite:
            return mat_id
        mid = mat_id.clamp_min(0).long()
        child_row = self.comp_child[mid]                 # (..., B)
        kk = k[..., None]
        hit = (child_row >= 0) & (kk >= self.comp_kmin[mid]) \
            & (kk < self.comp_kmax[mid])
        # argmax takes the first of equal maxima (and no bool input)
        first = torch.argmax(hit.to(torch.int32), dim=-1, keepdim=True)
        child = torch.gather(child_row, -1, first)[..., 0]
        out = torch.where(hit.any(-1), child, mid.to(mat_id.dtype))
        return torch.where(mat_id < 0, mat_id, out.to(mat_id.dtype))


def bake_materials(materials: list[model.Material], tex_ids: dict,
                   spec_ids: dict, cspec_ids: dict) -> dict:
    """Flatten host materials → {"pack": (M, 16), "comp_child",
    "comp_kmin", "comp_kmax": (M, 4)}. *_ids map id(host texture /
    spectrum / complex spectrum) → table row; composite children are rows
    of `materials` themselves."""
    M = max(len(materials), 1)
    pack = np.zeros((M, 16), np.float32)
    for c in (C_REFL_TEX, C_OPACITY_TEX, C_NORMALMAP_TEX, C_IOR, C_EXT_IOR,
              C_RSCALE, C_TSCALE, C_PROF_ROUGH_TEX):
        pack[:, c] = -1
    pack[:, C_SCALE] = 1.0
    pack[:, C_PROF_GAMMA] = 3.0
    pack[:, C_PROF_T] = 1.0
    comp_child = np.full((M, MAX_COMPOSITE_BINS), -1, np.int32)
    comp_kmin = np.zeros((M, MAX_COMPOSITE_BINS), np.float32)
    comp_kmax = np.zeros((M, MAX_COMPOSITE_BINS), np.float32)
    mat_row = {id(m): i for i, m in enumerate(materials)}
    for i, m in enumerate(materials):
        pack[i, C_TWOSIDED] = float(m.twosided)
        pack[i, C_SCALE] = m.scale
        if m.opacity is not None:
            pack[i, C_OPACITY_TEX] = tex_ids[id(m.opacity)]
        if m.normalmap is not None:
            pack[i, C_NORMALMAP_TEX] = tex_ids[id(m.normalmap)]
        b = m.bsdf
        if isinstance(b, model.DiffuseBSDF):
            pack[i, C_MTYPE] = MT_DIFFUSE
            pack[i, C_REFL_TEX] = tex_ids[id(b.reflectance)]
        elif isinstance(b, (model.DielectricBSDF, model.SpmBSDF)):
            pack[i, C_MTYPE] = (MT_DIELECTRIC
                                if isinstance(b, model.DielectricBSDF)
                                else MT_SPM)
            pack[i, C_IOR] = cspec_ids[id(b.ior)]
            if b.ext_ior is not None:
                pack[i, C_EXT_IOR] = cspec_ids[id(b.ext_ior)]
            if b.reflection_scale is not None:
                pack[i, C_RSCALE] = spec_ids[id(b.reflection_scale)]
            if b.transmission_scale is not None:
                pack[i, C_TSCALE] = spec_ids[id(b.transmission_scale)]
            if isinstance(b, model.SpmBSDF):
                p = b.profile
                pack[i, C_PROF_TYPE] = {
                    "dirac": profiles.PROFILE_DIRAC,
                    "gaussian": profiles.PROFILE_GAUSSIAN,
                    "fractal": profiles.PROFILE_FRACTAL}[p.type]
                pack[i, C_PROF_GAMMA] = p.gamma
                if p.roughness is not None:
                    pack[i, C_PROF_ROUGH_TEX] = tex_ids[id(p.roughness)]
                if p.T is not None:
                    pack[i, C_PROF_T] = p.T
                elif p.sigma is not None:
                    pack[i, C_PROF_T] = 1.0 / max(p.sigma ** 2, 1e-12)
                if p.sigma is not None:
                    pack[i, C_PROF_SIGMAH] = p.sigma
        elif isinstance(b, model.CompositeBSDF):
            pack[i, C_MTYPE] = MT_NULL   # outside all bins: no interaction
            for bi, (kmin, kmax, child) in enumerate(
                    b.bins[:MAX_COMPOSITE_BINS]):
                comp_child[i, bi] = mat_row[id(child)]
                comp_kmin[i, bi] = kmin
                comp_kmax[i, bi] = kmax
        elif b is None:
            pack[i, C_MTYPE] = MT_NULL
        else:
            raise TypeError(f"unsupported bsdf {type(b)}")
    return dict(pack=pack, comp_child=comp_child, comp_kmin=comp_kmin,
                comp_kmax=comp_kmax)
