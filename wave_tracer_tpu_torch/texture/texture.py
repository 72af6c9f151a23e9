"""Textures: host-side model and the baked device table.

Port of wave_tracer_tpu/texture/texture.py. The bake keeps the JAX
package's packed (T, 16) row layout (type, spectrum id, scale-spectrum id,
rgb, rgb2, uv transform, scale, atlas slot) and its bitmap atlas (every
bitmap's box-filtered mip pyramid packed along x, level 0 at x = 0), so
tables baked by either package load through the same bridge. A texture
evaluates to RGB (`eval_texture_rgb`) or to a scalar spectral value at
wavenumber k (`eval_texture_scalar`; RGB texels are uplifted through the
Smits basis). Given a uv-space footprint diameter `duv`, a bitmap lookup
is trilinear across the mip levels; without one it is bilinear on level 0.

The table records which row types it holds (`has_rgb`, `has_bitmap`,
`has_checker`): a lookup forms no term that no row of the table selects,
so a table of constant-spectrum textures costs what it did before the
other types were ported, and every result equals that of the JAX
module's full selection.
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
C_RGB2 = slice(6, 9)
C_UV_SCALE_U, C_UV_SCALE_V, C_UV_OFF_U, C_UV_OFF_V = 9, 10, 11, 12
C_SCALE = 13
C_SLOT = 14

MAX_MIPS = 8


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
class ConstantRGBTexture(Texture):
    rgb: tuple
    scale: float = 1.0
    scale_spectrum: Optional[Spectrum] = None


@dataclass
class BitmapTexture(Texture):
    """Image-backed texture; data (H, W, 3) float in linear space, row 0
    at the top (v = 1)."""
    data: np.ndarray
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)
    scale: float = 1.0
    scale_spectrum: Optional[Spectrum] = None


@dataclass
class CheckerboardTexture(Texture):
    rgb_a: tuple = (0.4, 0.4, 0.4)
    rgb_b: tuple = (0.2, 0.2, 0.2)
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)
    scale: float = 1.0
    scale_spectrum: Optional[Spectrum] = None


@dataclass
class TextureTable:
    pack: torch.Tensor        # (T, 16) packed rows (layout above)
    atlas: torch.Tensor       # (A, HMAX, 2·WMAX, 3) mip pyramids along x
    atlas_size: torch.Tensor  # (A, 2) i32 (h, w) of level 0
    mip_info: torch.Tensor    # (A, MAX_MIPS, 3) i32: x offset, h, w
    n_mips: torch.Tensor      # (A,) i32
    # row types present (host-known): rgb = any row read through RGB
    # (constant RGB, bitmap or checkerboard)
    has_rgb: bool = False
    has_bitmap: bool = False
    has_checker: bool = False


def _mip_atlas(bitmaps):
    """Pack each bitmap's 2×2 box-filtered mip pyramid along x."""
    if not bitmaps:
        mip_info = np.zeros((1, MAX_MIPS, 3), np.int32)
        mip_info[..., 1:] = 1
        return (np.zeros((1, 1, 2, 3), np.float32), np.ones((1, 2), np.int32),
                mip_info, np.ones(1, np.int32))
    hmax = max(b.data.shape[0] for b in bitmaps)
    wmax = max(b.data.shape[1] for b in bitmaps)
    atlas = np.zeros((len(bitmaps), hmax, 2 * wmax, 3), np.float32)
    sizes = np.zeros((len(bitmaps), 2), np.int32)
    mip_info = np.zeros((len(bitmaps), MAX_MIPS, 3), np.int32)
    n_mips = np.zeros(len(bitmaps), np.int32)
    for a, b in enumerate(bitmaps):
        img = np.asarray(b.data[..., :3], np.float32)
        sizes[a] = img.shape[:2]
        ox = 0
        for lvl in range(MAX_MIPS):
            lh, lw = img.shape[:2]
            atlas[a, :lh, ox:ox + lw] = img
            mip_info[a, lvl] = (ox, lh, lw)
            n_mips[a] = lvl + 1
            if lh <= 1 and lw <= 1:
                break
            # 2x2 box downsample (odd sizes pad by edge replication)
            if lh % 2:
                img = np.concatenate([img, img[-1:]], axis=0)
            if lw % 2:
                img = np.concatenate([img, img[:, -1:]], axis=1)
            img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                          + img[0::2, 1::2] + img[1::2, 1::2])
            ox += lw
        # unfilled deeper levels repeat the last one
        mip_info[a, n_mips[a]:] = mip_info[a, n_mips[a] - 1]
    return atlas, sizes, mip_info, n_mips


def bake_textures(textures: list[Texture],
                  spectrum_ids: dict[int, int]) -> dict:
    """Pack host textures → {"pack": (T, 16) f32, "atlas", "atlas_size",
    "mip_info", "n_mips"}. spectrum_ids maps id(spectrum obj) → baked
    spectrum row."""
    T = max(len(textures), 1)
    pack = np.zeros((T, 16), np.float32)
    pack[:, C_SPEC] = -1
    pack[:, C_SSCALE] = -1
    pack[:, C_RGB] = 1.0
    pack[:, 9:13] = (1, 1, 0, 0)      # uv scale.xy, offset.xy
    pack[:, C_SCALE] = 1.0
    pack[:, C_SLOT] = -1
    bitmaps = [t for t in textures if isinstance(t, BitmapTexture)]
    slot_of = {id(b): a for a, b in enumerate(bitmaps)}
    for i, t in enumerate(textures):
        pack[i, C_SCALE] = t.scale
        if t.scale_spectrum is not None:
            pack[i, C_SSCALE] = spectrum_ids[id(t.scale_spectrum)]
        if isinstance(t, ConstantSpectrumTexture):
            pack[i, C_TYPE] = TYPE_CONST_SPECTRUM
            pack[i, C_SPEC] = spectrum_ids[id(t.spectrum)]
        elif isinstance(t, ConstantRGBTexture):
            pack[i, C_TYPE] = TYPE_CONST_RGB
            pack[i, C_RGB] = t.rgb
        elif isinstance(t, BitmapTexture):
            pack[i, C_TYPE] = TYPE_BITMAP
            pack[i, C_SLOT] = slot_of[id(t)]
            pack[i, 9:13] = (*t.uv_scale, *t.uv_offset)
        elif isinstance(t, CheckerboardTexture):
            pack[i, C_TYPE] = TYPE_CHECKERBOARD
            pack[i, C_RGB] = t.rgb_a
            pack[i, C_RGB2] = t.rgb_b
            pack[i, 9:13] = (*t.uv_scale, *t.uv_offset)
        else:
            raise TypeError(f"unsupported texture {type(t)}")
    atlas, sizes, mip_info, n_mips = _mip_atlas(bitmaps)
    return dict(pack=pack, atlas=atlas, atlas_size=sizes, mip_info=mip_info,
                n_mips=n_mips)


def _bilinear_level(table: TextureTable, slot, u, v, level):
    """Bilinear fetch at one mip level (uv wraps)."""
    info = table.mip_info[slot, level]            # (..., 3) ox, h, w
    ox, hi, wi = info[..., 0], info[..., 1], info[..., 2]
    # image row 0 is the top; v = 0 is the bottom of the texture
    x = (u % 1.0) * wi.to(torch.float32) - 0.5
    y = (1.0 - (v % 1.0)) * hi.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    _, H, W2, _ = table.atlas.shape

    def tex(yy, xx):
        yy = (yy.to(torch.int32) % hi.clamp_min(1)).clamp(0, H - 1)
        xx = (ox + xx.to(torch.int32) % wi.clamp_min(1)).clamp(0, W2 - 1)
        return table.atlas[slot, yy.long(), xx.long()]

    return ((1 - fx) * (1 - fy) * tex(y0, x0) + fx * (1 - fy) * tex(y0, x0 + 1)
            + (1 - fx) * fy * tex(y0 + 1, x0) + fx * fy * tex(y0 + 1, x0 + 1))


def _bilinear(table: TextureTable, slot, u, v, duv=None):
    """Filtered atlas fetch: trilinear across the mip pyramid when a
    uv-space footprint diameter `duv` is given, level-0 bilinear else."""
    slot = slot.clamp_min(0).long()
    if duv is None:
        return _bilinear_level(table, slot, u, v, torch.zeros_like(slot))
    w0 = table.atlas_size[slot, 1].to(torch.float32)
    lod = torch.log2((duv * w0).clamp_min(1.0))
    nmax = (table.n_mips[slot] - 1).to(torch.float32)
    lod = torch.minimum(lod.clamp_min(0.0), nmax)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.minimum(l0 + 1, nmax.to(torch.int32))
    f = (lod - l0.to(torch.float32))[..., None]
    return (1.0 - f) * _bilinear_level(table, slot, u, v, l0.long()) \
        + f * _bilinear_level(table, slot, u, v, l1.long())


def _eval_rgb_row(table: TextureTable, row, uv, duv=None):
    """RGB value of packed texture rows (gathered by the caller)."""
    out = row[..., C_RGB]
    if table.has_bitmap or table.has_checker:
        typ = row[..., C_TYPE].to(torch.int32)
        u = uv[..., 0] * row[..., C_UV_SCALE_U] + row[..., C_UV_OFF_U]
        v = uv[..., 1] * row[..., C_UV_SCALE_V] + row[..., C_UV_OFF_V]
        if table.has_checker:
            even = ((torch.floor(u) + torch.floor(v)) % 2.0) < 1.0
            checker = torch.where(even[..., None], row[..., C_RGB],
                                  row[..., C_RGB2])
            out = torch.where((typ == TYPE_CHECKERBOARD)[..., None],
                              checker, out)
        if table.has_bitmap:
            if duv is not None:
                duv = duv * torch.maximum(row[..., C_UV_SCALE_U].abs(),
                                          row[..., C_UV_SCALE_V].abs())
            bitmap = _bilinear(table, row[..., C_SLOT].to(torch.int32), u,
                               v, duv)
            out = torch.where((typ == TYPE_BITMAP)[..., None], bitmap, out)
    return out * row[..., C_SCALE:C_SCALE + 1]


def eval_texture_rgb(table: TextureTable, spec_table: SpectrumTable, tex_id,
                     uv, duv=None):
    """RGB value of texture tex_id (...,) at uv (..., 2) → (..., 3). duv:
    optional uv-space footprint diameter for mip filtering. `spec_table`
    is unread (RGB rows need no spectrum) and kept for the JAX contract."""
    row = table.pack[tex_id.clamp_min(0).long()]
    return _eval_rgb_row(table, row, uv, duv)


def eval_texture_scalar(table: TextureTable, spec_table: SpectrumTable,
                        tex_id, uv, k, duv=None):
    """Scalar spectral value of texture tex_id (...,) at uv and
    wavenumber k. Constant-spectrum rows evaluate their baked spectrum;
    the others uplift their RGB value through the Smits basis. duv selects
    the mip level (trilinear) of bitmap rows when given."""
    row = table.pack[tex_id.clamp_min(0).long()]
    typ = row[..., C_TYPE].to(torch.int32)
    scale = row[..., C_SCALE]
    out = spec_table.eval(row[..., C_SPEC].to(torch.int32), k)
    if table.has_rgb:
        rgbv = _eval_rgb_row(table, row, uv, duv) \
            / scale.clamp_min(1e-30)[..., None]
        out = torch.where(typ == TYPE_CONST_SPECTRUM, out,
                          smits_uplift_dev(rgbv, k))
    out = out * scale
    sscale_id = row[..., C_SSCALE].to(torch.int32)
    sscale = torch.where(sscale_id >= 0, spec_table.eval(sscale_id, k),
                         torch.ones_like(out))
    return out * sscale
