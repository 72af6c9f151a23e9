"""The single door into the port's device tables.

`scene_data_from_numpy` uploads one flat dict of numpy arrays, keyed by the
dotted field paths of the JAX package's SceneData pytree ("geo.p0",
"tables.materials.pack", "emitters.etri_cdf", "spectral.e_w",
"edges.tri1", ...), to a SceneData of torch tensors on `device`. The
port's own `build_scene` bakes such a dict; a SceneData baked by the JAX
package, flattened with np.asarray on its leaves, loads the same way.
Both bakes write "edge_clusters.*", the clustered edge sweep's index,
and "tri_clusters.*", the triangle clusters of the clustered cone and
ball queries; both are required as the edge table is. One key is
optional: "geo.node_pack", the packed BVH that the BVH route walks (a
JAX bake's tree is loaded at every size, so the port walks the JAX tree;
the port's own bake writes one only where `accel/trace.py::route` names
the BVH: above MXU_MAX_TRIS triangles, or above BRUTE_THRESHOLD under
WT_TRACE_BACKEND=bvh|brute|cpu). Keys
the port does not read (Pallas feature layouts, the node arrays besides
node_pack) are ignored: the kernel rows are rebuilt here from
p0/e1/e2/mxu_center.

The tables learn here which row types and features they hold (the
`has_*` flags of the material, texture and emitter tables), so that the
device code forms no term that no row selects. A material, texture or
emitter type code the port does not know raises NotImplementedError
rather than render wrongly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.accel.bvh import check_traversable
from wave_tracer_tpu_torch.accel.edges import (CLUSTER_KEYS, EDGE_KEYS,
                                               EdgeClusters, EdgeTable)
from wave_tracer_tpu_torch.accel.trace import (TRI_CLUSTER_KEYS, GeoArrays,
                                               TriClusters)
from wave_tracer_tpu_torch.bsdf import table as mtab
from wave_tracer_tpu_torch.bsdf.device import Tables
from wave_tracer_tpu_torch.emitter import table as etab
from wave_tracer_tpu_torch.scene.spectral import SpectralSampler
from wave_tracer_tpu_torch.spectrum.bake import (ComplexSpectrumTable,
                                                 SpectrumTable)
from wave_tracer_tpu_torch.texture import texture as tex

GEO_KEYS = ("p0", "e1", "e2", "tri_geom", "tri_attr", "mxu_center")
MATERIAL_KEYS = ("pack", "comp_child", "comp_kmin", "comp_kmax")
TEXTURE_KEYS = ("pack", "atlas", "atlas_size", "mip_info", "n_mips")
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
# the clustered edge sweep's and the clustered triangle queries' indexes,
# required as KEYS are
CLUSTER_ROWS = tuple([f"edge_clusters.{k}" for k in CLUSTER_KEYS]
                     + [f"tri_clusters.{k}" for k in TRI_CLUSTER_KEYS])


@dataclass
class SceneData:
    """Everything the device integrator needs."""
    geo: GeoArrays
    tables: Tables
    emitters: etab.EmitterTable
    spectral: SpectralSampler      # for the primary sensor
    edges: EdgeTable               # classified wedge edges (FSD)
    edge_clusters: EdgeClusters    # the clustered sweep's index
    tri_clusters: TriClusters      # the clustered cone/ball queries' index


def _check_ported(a):
    codes = (
        ("material type", a["tables.materials.pack"][:, mtab.C_MTYPE],
         (mtab.MT_DIFFUSE, mtab.MT_DIELECTRIC, mtab.MT_SPM, mtab.MT_NULL)),
        ("texture type", a["tables.textures.pack"][:, tex.C_TYPE],
         (tex.TYPE_CONST_SPECTRUM, tex.TYPE_CONST_RGB, tex.TYPE_BITMAP,
          tex.TYPE_CHECKERBOARD)),
        ("emitter type", a["emitters.etype"],
         (etab.ET_AREA, etab.ET_POINT, etab.ET_SPOT, etab.ET_DIRECTIONAL)))
    for what, col, known in codes:
        unknown = np.setdiff1d(col.astype(np.int32), known)
        if unknown.size:
            raise NotImplementedError(
                f"{what} {unknown.tolist()} is not ported")


def scene_data_from_numpy(arrays: dict, device) -> SceneData:
    """Upload the flat numpy dict (see module doc) to `device`."""
    missing = [k for k in KEYS + CLUSTER_ROWS if k not in arrays]
    if missing:
        raise KeyError(f"scene arrays lack {missing}")
    a = {k: np.asarray(arrays[k]) for k in KEYS + CLUSTER_ROWS}
    _check_ported(a)

    def t(key, dtype=None):
        x = torch.tensor(a[key])      # copies (leaves may be read-only)
        return x.to(device=device, dtype=dtype or x.dtype)

    f32, i32 = torch.float32, torch.int32
    p0, e1, e2 = t("geo.p0", f32), t("geo.e1", f32), t("geo.e2", f32)
    center = t("geo.mxu_center", f32)
    node_pack = None
    if "geo.node_pack" in arrays:
        pack = np.asarray(arrays["geo.node_pack"])
        check_traversable(pack[:, 0], len(pack), len(a["geo.p0"]))
        node_pack = torch.tensor(pack).to(device=device, dtype=f32)
    geo = GeoArrays(p0=p0, e1=e1, e2=e2, tri_geom=t("geo.tri_geom", f32),
                    tri_attr=t("geo.tri_attr", f32), mxu_center=center,
                    node_pack=node_pack)
    mpack = a["tables.materials.pack"]
    mtype = mpack[:, mtab.C_MTYPE]
    ttype = a["tables.textures.pack"][:, tex.C_TYPE]
    tables = Tables(
        materials=mtab.MaterialTable(
            **{k: t(f"tables.materials.{k}", i32 if k == "comp_child"
                    else f32) for k in MATERIAL_KEYS},
            has_spm=bool((mtype == mtab.MT_SPM).any()),
            has_dielectric=bool((mtype == mtab.MT_DIELECTRIC).any()),
            has_mask=bool((mpack[:, mtab.C_OPACITY_TEX] >= 0).any()),
            has_normalmap=bool((mpack[:, mtab.C_NORMALMAP_TEX] >= 0).any()),
            has_composite=bool((a["tables.materials.comp_child"]
                                >= 0).any())),
        textures=tex.TextureTable(
            **{k: t(f"tables.textures.{k}", f32 if k in ("pack", "atlas")
                    else i32) for k in TEXTURE_KEYS},
            has_rgb=bool((ttype != tex.TYPE_CONST_SPECTRUM).any()),
            has_bitmap=bool((ttype == tex.TYPE_BITMAP).any()),
            has_checker=bool((ttype == tex.TYPE_CHECKERBOARD).any())),
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
        pse_scale=t("emitters.pse_scale", f32),
        has_spot=bool((a["emitters.etype"] == etab.ET_SPOT).any()),
        has_directional=bool((a["emitters.etype"]
                              == etab.ET_DIRECTIONAL).any()))
    spectral = spectral_from_numpy(
        {k: a[f"spectral.{k}"] for k in SPECTRAL_KEYS}, device)
    edges = EdgeTable(**{k: t(f"edges.{k}", i32 if k in ("tri1", "tri2")
                                else f32) for k in EDGE_KEYS})
    clusters = EdgeClusters(**{k: t(f"edge_clusters.{k}", f32 if k in (
        "center", "radius") else i32) for k in CLUSTER_KEYS})
    tri_clusters = TriClusters(**{k: t(f"tri_clusters.{k}", f32 if k in (
        "center", "radius") else i32) for k in TRI_CLUSTER_KEYS})
    return SceneData(geo=geo, tables=tables, emitters=emitters,
                     spectral=spectral, edges=edges, edge_clusters=clusters,
                     tri_clusters=tri_clusters)


def spectral_from_numpy(arrays: dict, device) -> SpectralSampler:
    """Upload one sensor's spectral-sampler tables (SPECTRAL_KEYS)."""
    return SpectralSampler(**{
        k: torch.tensor(np.asarray(arrays[k])).to(
            device=device,
            dtype=torch.int32 if k == "n_lines" else torch.float32)
        for k in SPECTRAL_KEYS})
