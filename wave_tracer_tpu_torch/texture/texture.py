"""Textures: host-side model and the baked device table.

Port of wave_tracer_tpu/texture/texture.py for constant textures. The bake
keeps the JAX package's packed (T, 16) row layout (type, spectrum id,
scale-spectrum id, rgb, rgb2, uv transform, scale, atlas slot), so tables
baked by either package load through the same bridge. Bitmap and
checkerboard textures are not ported yet: baking or loading one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from wave_tracer_tpu_torch.spectrum.bake import SpectrumTable, \
    smits_uplift_dev
from wave_tracer_tpu_torch.spectrum.spectra import Spectrum

TYPE_CONST_SPECTRUM = 0
TYPE_CONST_RGB = 1
TYPE_BITMAP = 2
TYPE_CHECKERBOARD = 3

# pack columns
C_TYPE, C_SPEC, C_SSCALE = 0, 1, 2
C_RGB = slice(3, 6)
C_SCALE = 13


class Texture:
    """Host-side texture node."""
    scale_spectrum: Optional[Spectrum] = None
    scale: float = 1.0


@dataclass
class ConstantSpectrumTexture(Texture):
    spectrum: Spectrum
    scale: float = 1.0
    scale_spectrum: Optional[Spectrum] = None


@dataclass
class TextureTable:
    pack: torch.Tensor       # (T, 16) packed rows (layout above)
    has_rgb: bool = False    # any TYPE_CONST_RGB row (host-known)


def bake_textures(textures: list[Texture],
                  spectrum_ids: dict[int, int]) -> dict:
    """Pack host textures → {"pack": (T, 16) f32}. spectrum_ids maps
    id(spectrum obj) → baked spectrum row."""
    T = max(len(textures), 1)
    pack = np.zeros((T, 16), np.float32)
    pack[:, C_SPEC] = -1
    pack[:, C_SSCALE] = -1
    pack[:, C_RGB] = 1.0
    pack[:, 9:13] = (1, 1, 0, 0)      # uv scale.xy, offset.xy
    pack[:, C_SCALE] = 1.0
    pack[:, 14] = -1                  # atlas slot
    for i, t in enumerate(textures):
        if not isinstance(t, ConstantSpectrumTexture):
            raise NotImplementedError(
                f"texture {type(t).__name__} is not ported yet")
        pack[i, C_TYPE] = TYPE_CONST_SPECTRUM
        pack[i, C_SPEC] = spectrum_ids[id(t.spectrum)]
        pack[i, C_SCALE] = t.scale
        if t.scale_spectrum is not None:
            pack[i, C_SSCALE] = spectrum_ids[id(t.scale_spectrum)]
    return dict(pack=pack)


def eval_texture_scalar(table: TextureTable, spec_table: SpectrumTable,
                        tex_id, uv, k):
    """Scalar spectral value of texture tex_id (...,) at wavenumber k.

    Constant-spectrum rows evaluate their baked spectrum; constant-RGB rows
    are uplifted through the Smits basis. `uv` is unused by constant
    textures and kept for the JAX contract."""
    row = table.pack[tex_id.clamp_min(0).long()]
    typ = row[..., C_TYPE].to(torch.int32)
    scale = row[..., C_SCALE]
    out = spec_table.eval(row[..., C_SPEC].to(torch.int32), k)
    if table.has_rgb:
        rgbv = row[..., C_RGB] * row[..., C_SCALE:C_SCALE + 1] \
            / scale.clamp_min(1e-30)[..., None]
        out = torch.where(typ == TYPE_CONST_SPECTRUM, out,
                          smits_uplift_dev(rgbv, k))
    out = out * scale
    sscale_id = row[..., C_SSCALE].to(torch.int32)
    sscale = torch.where(sscale_id >= 0, spec_table.eval(sscale_id, k),
                         torch.ones_like(out))
    return out * sscale
