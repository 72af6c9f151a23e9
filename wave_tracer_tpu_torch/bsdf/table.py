"""Device material table: packed rows for branch-free dispatch.

Port of wave_tracer_tpu/bsdf/table.py. The bake keeps the JAX package's
(M, 16) pack layout and the composite-child table, so tables baked by
either package load through the same bridge. Diffuse, surface_spm and
null rows bake here (an SPM row holds its complex-IOR rows, its
reflection/transmission scale spectra and its surface profile); the
dielectric and composite lobes are not ported yet and raise.
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
    pack: torch.Tensor     # (M, 16) all scalar fields as f32
    # any surface_spm row (host-known): a table without one skips the SPM
    # lobe's arithmetic, whose result no lane would select
    has_spm: bool = False

    @property
    def count(self):
        return self.pack.shape[0]


def bake_materials(materials: list[model.Material], tex_ids: dict,
                   spec_ids: dict, cspec_ids: dict) -> dict:
    """Flatten host materials → {"pack": (M, 16), "comp_child": (M, 4)}.
    *_ids map id(host texture / spectrum / complex spectrum) → table row."""
    M = max(len(materials), 1)
    pack = np.zeros((M, 16), np.float32)
    for c in (C_REFL_TEX, C_OPACITY_TEX, C_NORMALMAP_TEX, C_IOR, C_EXT_IOR,
              C_RSCALE, C_TSCALE, C_PROF_ROUGH_TEX):
        pack[:, c] = -1
    pack[:, C_SCALE] = 1.0
    pack[:, C_PROF_GAMMA] = 3.0
    pack[:, C_PROF_T] = 1.0
    for i, m in enumerate(materials):
        if m.opacity is not None or m.normalmap is not None:
            raise NotImplementedError(
                "opacity masks and normal maps are not ported yet")
        pack[i, C_TWOSIDED] = float(m.twosided)
        pack[i, C_SCALE] = m.scale
        b = m.bsdf
        if isinstance(b, model.DiffuseBSDF):
            pack[i, C_MTYPE] = MT_DIFFUSE
            pack[i, C_REFL_TEX] = tex_ids[id(b.reflectance)]
        elif isinstance(b, model.SpmBSDF):
            pack[i, C_MTYPE] = MT_SPM
            pack[i, C_IOR] = cspec_ids[id(b.ior)]
            if b.ext_ior is not None:
                pack[i, C_EXT_IOR] = cspec_ids[id(b.ext_ior)]
            if b.reflection_scale is not None:
                pack[i, C_RSCALE] = spec_ids[id(b.reflection_scale)]
            if b.transmission_scale is not None:
                pack[i, C_TSCALE] = spec_ids[id(b.transmission_scale)]
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
        elif b is None:
            pack[i, C_MTYPE] = MT_NULL
        else:
            raise NotImplementedError(
                f"bsdf {type(b).__name__} is not ported yet (the port "
                "renders diffuse, surface_spm and null materials)")
    comp_child = np.full((M, MAX_COMPOSITE_BINS), -1, np.int32)
    return dict(pack=pack, comp_child=comp_child)
