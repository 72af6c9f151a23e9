"""Scene → device bake: one flat dict of numpy arrays, then SceneData.

Port of wave_tracer_tpu/scene/build.py for the ported subset. Collects
every spectrum, complex spectrum, texture and material reachable from the
host scene (and the sensors' response spectra), assigns table rows,
merges all shapes into one triangle soup, classifies its wedge edges for
free-space diffraction (and clusters them for the clustered sweep),
clusters the triangles for the clustered cone and ball queries, and
bakes the emitter and spectral-sampling tables into a dict keyed like the
JAX SceneData (scene/bridge.py), which `scene_data_from_numpy` uploads.
Up to MXU_MAX_TRIS triangles the soup keeps its order (the all-pairs
kernels need no BVH); above it, and above BRUTE_THRESHOLD under
WT_TRACE_BACKEND=bvh|brute|cpu (where the ray queries take the BVH,
`accel/trace.py::route`), a BVH is built (accel/bvh.py) and every
triangle table, the edge table's and the emitters' triangle ids included,
is baked in its leaf order, as the JAX package bakes every scene. Such a
bake up to MXU_MAX_TRIS triangles still gets K1/K2's tables, so it also
renders under the default route.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from wave_tracer_tpu_torch.accel import bvh as bvh_mod
from wave_tracer_tpu_torch.accel import edges as edges_mod
from wave_tracer_tpu_torch.accel import trace as trace_mod
from wave_tracer_tpu_torch.bsdf import model as bmodel
from wave_tracer_tpu_torch.bsdf.table import bake_materials
from wave_tracer_tpu_torch.emitter.table import bake_emitters
from wave_tracer_tpu_torch.geometry.mesh import TriangleSoup
from wave_tracer_tpu_torch.scene.bridge import (SceneData,
                                                scene_data_from_numpy,
                                                spectral_from_numpy)
from wave_tracer_tpu_torch.scene.model import Scene
from wave_tracer_tpu_torch.scene.spectral import build_spectral_sampler
from wave_tracer_tpu_torch.spectrum.bake import bake_complex, bake_spectra
from wave_tracer_tpu_torch.texture.texture import bake_textures


@dataclass
class BuiltScene:
    scene: Scene
    data: SceneData                # device tables (primary sensor)
    arrays: dict                   # the flat numpy bake (bridge keys)
    spectral_arrays: list          # per-sensor spectral tables (numpy)
    spectral_per_sensor: list      # [SpectralSampler] on data's device

    @staticmethod
    def upload(scene, arrays, spectral_arrays, device) -> "BuiltScene":
        return BuiltScene(
            scene=scene, data=scene_data_from_numpy(arrays, device),
            arrays=arrays, spectral_arrays=spectral_arrays,
            spectral_per_sensor=[spectral_from_numpy(s, device)
                                 for s in spectral_arrays])

    @property
    def device(self):
        return self.data.geo.p0.device

    def on(self, device) -> "BuiltScene":
        """The same bake uploaded to another device."""
        return BuiltScene.upload(self.scene, self.arrays,
                                 self.spectral_arrays, device)


def _collect(scene: Scene):
    """Register spectra, complex spectra, textures and materials
    (first-seen order, as the JAX package registers them; composite
    children get rows of their own)."""
    spectra, cspectra, textures, materials = [], [], [], []
    sp_ids, csp_ids, tex_ids = {}, {}, {}

    def add_spec(s):
        if s is not None and id(s) not in sp_ids:
            sp_ids[id(s)] = len(spectra)
            spectra.append(s)

    def add_cspec(s):
        if s is not None and id(s) not in csp_ids:
            csp_ids[id(s)] = len(cspectra)
            cspectra.append(s)

    def add_tex(t):
        if t is not None and id(t) not in tex_ids:
            tex_ids[id(t)] = len(textures)
            textures.append(t)
            add_spec(getattr(t, "spectrum", None))
            add_spec(getattr(t, "scale_spectrum", None))

    def add_mat(m):
        if m is None or any(m is x for x in materials):
            return
        materials.append(m)
        add_tex(m.opacity)
        add_tex(m.normalmap)
        b = m.bsdf
        if isinstance(b, bmodel.DiffuseBSDF):
            add_tex(b.reflectance)
        elif isinstance(b, (bmodel.DielectricBSDF, bmodel.SpmBSDF)):
            add_cspec(b.ior)
            add_cspec(b.ext_ior)
            add_spec(b.reflection_scale)
            add_spec(b.transmission_scale)
            if isinstance(b, bmodel.SpmBSDF):
                add_tex(b.profile.roughness)
        elif isinstance(b, bmodel.CompositeBSDF):
            for _, _, child in b.bins:
                add_mat(child)

    for shape in scene.shapes:
        add_mat(shape.material)
    for em in scene.emitters:
        add_spec(em.spectrum)
    for sensor in scene.sensors:
        add_spec(sensor.response.spectrum)
        for cs in sensor.response.channel_spectra:
            add_spec(cs)
    return spectra, sp_ids, cspectra, csp_ids, textures, tex_ids, materials


def bake_scene_arrays(scene: Scene):
    """Host bake → (flat dict of numpy arrays keyed as in scene/bridge.py,
    list of per-sensor spectral-sampler dicts)."""
    (spectra, sp_ids, cspectra, csp_ids, textures, tex_ids,
     materials) = _collect(scene)
    mat_row = {id(m): i for i, m in enumerate(materials)}

    soups, mat_id, shape_id, emitter_id = [], [], [], []
    emitter_index = {id(e): i for i, e in enumerate(scene.emitters)}
    for si, shape in enumerate(scene.shapes):
        T = shape.soup.num_tris
        if T == 0:
            continue
        soups.append(shape.soup)
        mat_id.append(np.full(T, mat_row[id(shape.material)], np.int32))
        shape_id.append(np.full(T, si, np.int32))
        eid = emitter_index.get(id(shape.emitter), -1) \
            if shape.emitter is not None else -1
        emitter_id.append(np.full(T, eid, np.int32))
        if shape.emitter is not None:
            shape.emitter.shape_index = si
    if not soups:
        raise ValueError("scene has no triangles")
    soup = TriangleSoup.concatenate(soups)
    mat_id, shape_id, emitter_id = (np.concatenate(x) for x in (
        mat_id, shape_id, emitter_id))
    bvh = None
    if trace_mod.route(soup.num_tris) == "bvh":
        # every table below names triangles in the BVH's leaf order
        bvh = bvh_mod.build_bvh(soup.positions)
        perm = bvh.tri_order
        soup = soup.take(perm)
        mat_id, shape_id, emitter_id = (x[perm] for x in (
            mat_id, shape_id, emitter_id))

    out = {}

    def put(prefix, d):
        out.update({f"{prefix}.{k}": v for k, v in d.items()})

    put("geo", trace_mod.from_soup(soup, mat_id, shape_id, emitter_id, bvh))
    # cap = the query's candidates per cluster (WT_TRI_CAP), so that a
    # query sees every member of a cluster
    put("tri_clusters", trace_mod.build_tri_clusters(
        out["geo.p0"], out["geo.e1"], out["geo.e2"], cap=trace_mod.TRI_CAP))
    put("tables.spectra", bake_spectra(spectra))
    put("tables.textures", bake_textures(textures, sp_ids))
    put("tables.cspectra", bake_complex(cspectra))
    put("tables.materials", bake_materials(materials, tex_ids, sp_ids,
                                           csp_ids))
    put("emitters", bake_emitters(scene.emitters, sp_ids, emitter_id,
                                  soup.areas(),
                                  scene_radius=scene.world_radius()))
    edges = edges_mod.classify_edges(soup.positions, soup.geo_n)
    put("edges", edges)
    put("edge_clusters", edges_mod.build_edge_clusters(edges))
    per_sensor = [build_spectral_sampler(
        scene.emitters, s.response.sensitivity_spectrum())
        for s in scene.sensors]
    if not per_sensor:
        raise ValueError("scene has no sensors")
    put("spectral", per_sensor[0])
    return out, per_sensor


def build_scene(scene: Scene, device="cuda") -> BuiltScene:
    """Bake `scene` on the host and upload it to `device`."""
    arrays, per_sensor = bake_scene_arrays(scene)
    return BuiltScene.upload(scene, arrays, per_sensor, device)
