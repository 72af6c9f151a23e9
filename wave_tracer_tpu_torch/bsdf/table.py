"""Device material table: packed rows for branch-free dispatch.

Port of wave_tracer_tpu/bsdf/table.py. The bake keeps the JAX package's
(M, 16) pack layout and the composite-child table, so tables baked by
either package load through the same bridge. Only diffuse and null rows
bake here; dielectric, surface_spm and composite materials are not ported
yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.bsdf import model

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

    @property
    def count(self):
        return self.pack.shape[0]


def bake_materials(materials: list[model.Material], tex_ids: dict) -> dict:
    """Flatten host materials → {"pack": (M, 16), "comp_child": (M, 4)}.
    tex_ids maps id(host texture) → texture row."""
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
        elif b is None:
            pack[i, C_MTYPE] = MT_NULL
        else:
            raise NotImplementedError(
                f"bsdf {type(b).__name__} is not ported yet")
    comp_child = np.full((M, MAX_COMPOSITE_BINS), -1, np.int32)
    return dict(pack=pack, comp_child=comp_child)
