"""The single door into the port's device tables.

`scene_data_from_numpy` uploads one flat dict of numpy arrays, keyed by the
dotted field paths of the JAX package's SceneData pytree ("geo.p0",
"tables.materials.pack", "emitters.etri_cdf", "spectral.e_w",
"edges.tri1", ...), to a SceneData of torch tensors on `device`. The
port's own `build_scene` bakes such a dict; a SceneData baked by the JAX
package, flattened with np.asarray on its leaves, loads the same way.
Keys the port does not read (BVH nodes, Pallas feature layouts, edge and
triangle clusters) are ignored: the kernel rows are rebuilt here from
p0/e1/e2/mxu_center.

Rows the port cannot render (dielectric and composite materials, opacity
masks, normal maps, bitmap/checker textures, spot or directional
emitters) raise NotImplementedError here rather than render wrongly;
diffuse, surface_spm and null rows load, with the complex-IOR table
(`tables.cspectra.*`) that SPM rows read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.accel import ray_kernels
from wave_tracer_tpu_torch.accel.edges import EDGE_KEYS, EdgeTable
from wave_tracer_tpu_torch.accel.trace import GeoArrays
from wave_tracer_tpu_torch.bsdf import table as mtab
from wave_tracer_tpu_torch.bsdf.device import Tables
from wave_tracer_tpu_torch.emitter import table as etab
from wave_tracer_tpu_torch.scene.spectral import SpectralSampler
from wave_tracer_tpu_torch.spectrum.bake import (ComplexSpectrumTable,
                                                 SpectrumTable)
from wave_tracer_tpu_torch.texture import texture as tex

GEO_KEYS = ("p0", "e1", "e2", "tri_geom", "tri_attr", "mxu_center")
MATERIAL_KEYS = ("pack", "comp_child")
TEXTURE_KEYS = ("pack",)
SPECTRA_KEYS = ("vals", "log_kmin", "log_kmax")
CSPECTRA_KEYS = ("n", "kappa", "log_kmin", "log_kmax")
EMITTER_KEYS = ("pack", "etype", "spec_id", "power", "area_total",
                "etri_idx", "etri_cdf", "scene_radius", "dir", "cos_cutoff",
                "pse_scale")
SPECTRAL_KEYS = ("e_w", "e_cdf", "x", "f", "cdf", "total", "line_k",
                 "line_w", "n_lines")

KEYS = tuple([f"geo.{k}" for k in GEO_KEYS]
             + [f"tables.materials.{k}" for k in MATERIAL_KEYS]
             + [f"tables.textures.{k}" for k in TEXTURE_KEYS]
             + [f"tables.spectra.{k}" for k in SPECTRA_KEYS]
             + [f"tables.cspectra.{k}" for k in CSPECTRA_KEYS]
             + [f"emitters.{k}" for k in EMITTER_KEYS]
             + [f"spectral.{k}" for k in SPECTRAL_KEYS]
             + [f"edges.{k}" for k in EDGE_KEYS])


@dataclass
class SceneData:
    """Everything the device integrator needs."""
    geo: GeoArrays
    tables: Tables
    emitters: etab.EmitterTable
    spectral: SpectralSampler      # for the primary sensor
    edges: EdgeTable               # classified wedge edges (FSD)


def _check_ported(a):
    pack = a["tables.materials.pack"]
    mtype = pack[:, mtab.C_MTYPE].astype(np.int32)
    if not np.isin(mtype, (mtab.MT_DIFFUSE, mtab.MT_SPM,
                           mtab.MT_NULL)).all():
        raise NotImplementedError(
            "dielectric materials are not ported yet (the port renders "
            "diffuse, surface_spm and null materials)")
    if (pack[:, mtab.C_OPACITY_TEX] >= 0).any() \
            or (pack[:, mtab.C_NORMALMAP_TEX] >= 0).any():
        raise NotImplementedError(
            "opacity masks and normal maps are not ported yet")
    if (a["tables.materials.comp_child"] >= 0).any():
        raise NotImplementedError("composite materials are not ported yet")
    ttype = a["tables.textures.pack"][:, tex.C_TYPE].astype(np.int32)
    if not np.isin(ttype, (tex.TYPE_CONST_SPECTRUM,
                           tex.TYPE_CONST_RGB)).all():
        raise NotImplementedError(
            "bitmap and checkerboard textures are not ported yet")
    if not np.isin(a["emitters.etype"], (etab.ET_AREA, etab.ET_POINT)).all():
        raise NotImplementedError(
            "spot and directional emitters are not ported yet")


def scene_data_from_numpy(arrays: dict, device) -> SceneData:
    """Upload the flat numpy dict (see module doc) to `device`."""
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"scene arrays lack {missing}")
    a = {k: np.asarray(arrays[k]) for k in KEYS}
    _check_ported(a)

    def t(key, dtype=None):
        x = torch.tensor(a[key])      # copies (leaves may be read-only)
        return x.to(device=device, dtype=dtype or x.dtype)

    f32, i32 = torch.float32, torch.int32
    p0, e1, e2 = t("geo.p0", f32), t("geo.e1", f32), t("geo.e2", f32)
    center = t("geo.mxu_center", f32)
    geo = GeoArrays(p0=p0, e1=e1, e2=e2, tri_geom=t("geo.tri_geom", f32),
                    tri_attr=t("geo.tri_attr", f32), mxu_center=center,
                    tri_feat=ray_kernels.tri_features(p0, e1, e2, center))
    tpack = a["tables.textures.pack"]
    tables = Tables(
        materials=mtab.MaterialTable(
            pack=t("tables.materials.pack", f32),
            has_spm=bool((a["tables.materials.pack"][:, mtab.C_MTYPE]
                          == mtab.MT_SPM).any())),
        textures=tex.TextureTable(
            pack=t("tables.textures.pack", f32),
            has_rgb=bool((tpack[:, tex.C_TYPE] == tex.TYPE_CONST_RGB).any())),
        spectra=SpectrumTable(vals=t("tables.spectra.vals", f32),
                              log_kmin=t("tables.spectra.log_kmin", f32),
                              log_kmax=t("tables.spectra.log_kmax", f32)),
        cspectra=ComplexSpectrumTable(
            **{k: t(f"tables.cspectra.{k}", f32) for k in CSPECTRA_KEYS}))
    emitters = etab.EmitterTable(
        pack=t("emitters.pack", f32), etype=t("emitters.etype", i32),
        spec_id=t("emitters.spec_id", i32), power=t("emitters.power", f32),
        area_total=t("emitters.area_total", f32),
        etri_idx=t("emitters.etri_idx", i32),
        etri_cdf=t("emitters.etri_cdf", f32),
        scene_radius=t("emitters.scene_radius", f32),
        dir=t("emitters.dir", f32), cos_cutoff=t("emitters.cos_cutoff", f32),
        pse_scale=t("emitters.pse_scale", f32))
    spectral = spectral_from_numpy(
        {k: a[f"spectral.{k}"] for k in SPECTRAL_KEYS}, device)
    edges = EdgeTable(**{k: t(f"edges.{k}", i32 if k in ("tri1", "tri2")
                                else f32) for k in EDGE_KEYS})
    return SceneData(geo=geo, tables=tables, emitters=emitters,
                     spectral=spectral, edges=edges)


def spectral_from_numpy(arrays: dict, device) -> SpectralSampler:
    """Upload one sensor's spectral-sampler tables (SPECTRAL_KEYS)."""
    return SpectralSampler(**{
        k: torch.tensor(np.asarray(arrays[k])).to(
            device=device,
            dtype=torch.int32 if k == "n_lines" else torch.float32)
        for k in SPECTRAL_KEYS})
