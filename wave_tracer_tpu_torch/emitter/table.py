"""Device emitter table: NEE sampling, emission evaluation, pdfs.

Port of wave_tracer_tpu/emitter/table.py for area, point, spot and
directional emitters: NEE (`sample_direct`), emission
(`emission_radiance`), emitted-ray sampling for light subpaths
(`sample_emission`) and their pdfs. The bake keeps the JAX package's
(E, 20) pack layout and its concatenated per-emitter triangle CDF
(triangle indices in the device triangle order of the GeoArrays the table
is used with). A directional emitter shines from a disk of the scene's
bounding radius. The table records whether it holds spot or directional
rows (`has_spot`, `has_directional`): their branches make no launch in a
table without them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.sampling import warps

ET_AREA = 0
ET_POINT = 1
ET_SPOT = 2
ET_DIRECTIONAL = 3

# pack columns
C_ETYPE = 0
C_POS = slice(1, 4)
C_DIR = slice(4, 7)
C_COS_BEAM = 7
C_COS_CUTOFF = 8
C_BEAM_ANGLE = 9
C_CUTOFF_ANGLE = 10
C_SPEC = 11
C_POWER = 12
C_AREA = 13
C_TRI_START = 14
C_TRI_COUNT = 15


@dataclass
class EmitterTable:
    pack: torch.Tensor        # (E, 20) packed rows (layout above)
    etype: torch.Tensor       # (E,) i32
    spec_id: torch.Tensor     # (E,) i32 baked spectrum row
    power: torch.Tensor       # (E,) selection weights
    area_total: torch.Tensor  # (E,)
    etri_idx: torch.Tensor    # (TT,) i32 triangle index in GeoArrays
    etri_cdf: torch.Tensor    # (TT,) inclusive CDF normalized per emitter
    scene_radius: torch.Tensor  # () scene bounding radius
    dir: torch.Tensor         # (E, 3) propagation direction
    cos_cutoff: torch.Tensor  # (E,) (spot; 1 for the other types)
    pse_scale: torch.Tensor   # (E,) phase_space_extent_scale
    has_spot: bool = False         # host-known row types
    has_directional: bool = False

    @property
    def count(self):
        return self.etype.shape[0]


def bake_emitters(emitters, spec_ids, tri_emitter_id: np.ndarray,
                  tri_areas: np.ndarray, scene_radius: float) -> dict:
    """Host bake → dict of numpy arrays; tri_* in device triangle order.
    Sets `area` on each area emitter (its power depends on it)."""
    from wave_tracer_tpu_torch.emitter import model
    E = max(len(emitters), 1)
    etype = np.zeros(E, np.int32)
    pos = np.zeros((E, 3), np.float32)
    edir = np.tile(np.array([0, 0, 1], np.float32), (E, 1))
    cosb = np.ones(E, np.float32)
    cosc = np.ones(E, np.float32)
    ba = np.zeros(E, np.float32)
    ca = np.zeros(E, np.float32)
    spec = np.full(E, -1, np.int32)
    power = np.zeros(E, np.float32)
    atot = np.zeros(E, np.float32)
    ts = np.zeros(E, np.int32)
    tc = np.zeros(E, np.int32)
    pse = np.ones(E, np.float32)

    idx_list, cdf_list = [], []
    off = 0
    for i, em in enumerate(emitters):
        spec[i] = spec_ids[id(em.spectrum)]
        pse[i] = em.phase_space_extent_scale
        if isinstance(em, model.AreaEmitter):
            etype[i] = ET_AREA
            mine = np.nonzero(tri_emitter_id == i)[0]
            areas = tri_areas[mine]
            total = float(areas.sum())
            atot[i] = total
            ts[i] = off
            tc[i] = len(mine)
            idx_list.append(mine.astype(np.int32))
            cdf_list.append((np.cumsum(areas) / max(total, 1e-30))
                            .astype(np.float32))
            off += len(mine)
            em.area = total
        elif isinstance(em, model.PointEmitter):
            etype[i] = ET_POINT
            pos[i] = em.position
        elif isinstance(em, model.SpotEmitter):
            etype[i] = ET_SPOT
            pos[i] = em.position
            edir[i] = em.direction
            cosb[i] = np.cos(em.beam_width)
            cosc[i] = np.cos(em.cutoff)
            ba[i] = em.beam_width
            ca[i] = em.cutoff
        elif isinstance(em, model.DirectionalEmitter):
            etype[i] = ET_DIRECTIONAL
            edir[i] = em.direction
            em.scene_radius = scene_radius
        else:
            raise TypeError(f"unsupported emitter {type(em)}")
        power[i] = em.power()

    etri_idx = np.concatenate(idx_list) if idx_list \
        else np.zeros(1, np.int32)
    etri_cdf = np.concatenate(cdf_list) if cdf_list \
        else np.ones(1, np.float32)
    pack = np.zeros((E, 20), np.float32)
    pack[:, C_ETYPE] = etype
    pack[:, C_POS] = pos
    pack[:, C_DIR] = edir
    pack[:, C_COS_BEAM] = cosb
    pack[:, C_COS_CUTOFF] = cosc
    pack[:, C_BEAM_ANGLE] = ba
    pack[:, C_CUTOFF_ANGLE] = ca
    pack[:, C_SPEC] = spec
    pack[:, C_POWER] = power
    pack[:, C_AREA] = atot
    pack[:, C_TRI_START] = ts
    pack[:, C_TRI_COUNT] = tc
    pack[:, 16] = pse
    return dict(pack=pack, etype=etype, spec_id=spec, power=power,
                area_total=atot, etri_idx=etri_idx, etri_cdf=etri_cdf,
                scene_radius=np.asarray(scene_radius, np.float32),
                dir=edir, cos_cutoff=cosc, pse_scale=pse)


def _spot_falloff_row(row, local_cos):
    """Linear angular falloff of a spot row: 1 inside the beam width, 0
    outside the cutoff, linear in the angle between."""
    cutoff = row[..., C_CUTOFF_ANGLE]
    beam = row[..., C_BEAM_ANGLE]
    theta = torch.arccos(local_cos.clamp(-1.0 + 1e-6, 1.0 - 1e-6))
    w = (cutoff - theta) / (cutoff - beam).clamp_min(1e-9)
    zero = torch.zeros_like(w)
    return torch.where(local_cos <= row[..., C_COS_CUTOFF], zero,
                       torch.where(local_cos >= row[..., C_COS_BEAM],
                                   zero + 1.0, w)).clamp(0.0, 1.0)


def _sample_area_point(et: EmitterTable, geo, row, u3):
    """Uniform-area point on an area emitter: (y, n, pdf_area, tri)."""
    start = row[..., C_TRI_START].long()
    cnt = row[..., C_TRI_COUNT].long().clamp_min(1)
    # fixed-count binary search over this emitter's slice of the CDF
    steps = max(1, int(et.etri_cdf.shape[0] - 1).bit_length())
    lo = torch.zeros_like(start)
    hi = cnt - 1
    target = u3[..., 0]
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = et.etri_cdf[start + mid] < target
        lo = torch.where(go_right, torch.minimum(mid + 1, hi), lo)
        hi = torch.where(go_right, hi, mid)
    ti = et.etri_idx[start + lo].long()
    b = warps.uniform_triangle(u3[..., 1:3])
    trow = geo.tri_geom[ti]
    y = trow[..., 0:3] + b[..., 0:1] * trow[..., 3:6] \
        + b[..., 1:2] * trow[..., 6:9]
    n = geo.tri_attr[ti][..., 15:18]              # geometric normal
    pdf_area = 1.0 / row[..., C_AREA].clamp_min(1e-30)
    return y, n, pdf_area, ti


def sample_direct(et: EmitterTable, geo, spec_table, e, x, k, u3):
    """NEE toward emitter e from point x.

    Returns dict: wo (unit, x→emitter), dist, Li (spectral radiance-like
    contribution already including 1/d² for point and spot emitters and
    the spot falloff), pdf_sa (solid-angle density; 1 for delta lobes),
    delta_dir, y (light point), ln (light normal), valid, tri (light
    triangle or -1). A directional emitter's shadow ray runs 4 scene
    radii toward it."""
    row = et.pack[e.long()]
    spec_val = spec_table.eval(row[..., C_SPEC].to(torch.int32), k)
    etype = row[..., C_ETYPE].to(torch.int32)

    # area
    y_a, ln_a, pdf_area, tri_a = _sample_area_point(et, geo, row, u3)
    d_a = y_a - x
    dist2_a = vec.length2(d_a).clamp_min(1e-20)
    dist_a = torch.sqrt(dist2_a)
    wo_a = d_a / dist_a[..., None]
    cos_l = -vec.dot(wo_a, ln_a)
    front = cos_l > 1e-7
    pdf_sa_a = pdf_area * dist2_a / cos_l.clamp_min(1e-7)
    Li_a = torch.where(front, spec_val, torch.zeros_like(spec_val))

    # point / spot (delta position): I(k)/d² [× falloff]
    y_p = row[..., C_POS]
    d_p = y_p - x
    dist2_p = vec.length2(d_p).clamp_min(1e-20)
    dist_p = torch.sqrt(dist2_p)
    wo_p = d_p / dist_p[..., None]
    Li_p = spec_val / dist2_p

    is_area = etype == ET_AREA
    wo = torch.where(is_area[..., None], wo_a, wo_p)
    dist = torch.where(is_area, dist_a, dist_p)
    Li = torch.where(is_area, Li_a, Li_p)
    if et.has_spot:
        falloff = _spot_falloff_row(row, -vec.dot(wo_p, row[..., C_DIR]))
        Li = torch.where(etype == ET_SPOT, Li_p * falloff, Li)
    if et.has_directional:
        # a delta direction toward −dir
        is_dir = etype == ET_DIRECTIONAL
        wo = torch.where(is_dir[..., None], -row[..., C_DIR], wo)
        dist = torch.where(is_dir, 4.0 * et.scene_radius, dist)
        Li = torch.where(is_dir, spec_val, Li)
    pdf_sa = torch.where(is_area, pdf_sa_a, torch.ones_like(pdf_sa_a))
    y = torch.where(is_area[..., None], y_a, y_p)
    ln = torch.where(is_area[..., None], ln_a, -wo)
    tri = torch.where(is_area, tri_a, torch.full_like(tri_a, -1))
    return dict(wo=wo, dist=dist, Li=Li, pdf_sa=pdf_sa, delta_dir=~is_area,
                y=y, ln=ln, valid=Li > 0.0, tri=tri)


def emission_radiance(et: EmitterTable, spec_table, emitter_id, k,
                      cos_out):
    """Le of an area emitter hit from the front (cos_out > 0)."""
    eid = emitter_id.clamp_min(0).long()
    val = spec_table.eval(et.spec_id[eid], k)
    return torch.where((emitter_id >= 0) & (cos_out > 0), val,
                       torch.zeros_like(val))


def pdf_direct_solid_angle(et: EmitterTable, emitter_id, dist2, cos_l):
    """Density that sample_direct would have produced this direction (for
    MIS with BSDF sampling); area emitters only."""
    eid = emitter_id.clamp_min(0).long()
    pdf = dist2 / (cos_l.clamp_min(1e-7)
                   * et.area_total[eid].clamp_min(1e-30))
    ok = (emitter_id >= 0) & (et.etype[eid] == ET_AREA) & (cos_l > 1e-7)
    return torch.where(ok, pdf, torch.zeros_like(pdf))


def sample_emission(et: EmitterTable, geo, spec_table, e, k, u4):
    """Forward transport: sample an emitted ray of emitter e (area:
    uniform position and cosine direction; point: uniform sphere; spot:
    uniform cone of its cutoff; directional: a uniform point of the disk
    of the scene's radius, 2 radii back along its direction). Returns dict
    with position y, normal ln, direction wo, weight (spectral power per
    unit pdf), pdf_area, pdf_dir, valid."""
    from wave_tracer_tpu_torch.math import frame as frame_mod
    row = et.pack[e.long()]                       # ONE packed gather
    spec_val = spec_table.eval(row[..., C_SPEC].to(torch.int32), k)
    etype = row[..., C_ETYPE].to(torch.int32)

    # area: uniform position, cosine direction
    y_a, ln_a, pdf_area_a, _ = _sample_area_point(et, geo, row, u4[..., :3])
    fr = frame_mod.build_orthogonal_frame(ln_a)
    wo_loc = warps.cosine_hemisphere(
        torch.stack([u4[..., 3], u4[..., 0]], dim=-1))
    wo_area = fr.to_world(wo_loc)
    pdf_dir_a = warps.cosine_hemisphere_pdf(wo_loc[..., 2])
    # point: uniform sphere
    wo_pt = warps.uniform_sphere(u4[..., 0:2])

    is_area = etype == ET_AREA
    a3 = is_area[..., None]
    one = torch.ones_like(pdf_area_a)
    y = torch.where(a3, y_a, row[..., C_POS])
    wo = torch.where(a3, wo_area, wo_pt)
    pdf_area = torch.where(is_area, pdf_area_a, one)
    pdf_dir = torch.where(is_area, pdf_dir_a,
                          one * warps.uniform_sphere_pdf())
    if et.has_spot:
        # spot: uniform cone of the cutoff angle
        is_spot = etype == ET_SPOT
        e_dir = row[..., C_DIR].expand(y_a.shape)
        sa_cut = 2.0 * math.pi * (1.0 - row[..., C_COS_CUTOFF])
        wo_sp_loc = warps.uniform_cone(sa_cut, u4[..., 0:2])
        wo = torch.where(
            is_spot[..., None],
            frame_mod.build_orthogonal_frame(e_dir).to_world(wo_sp_loc), wo)
        pdf_dir = torch.where(is_spot, 1.0 / sa_cut, pdf_dir)
    ln = torch.where(a3, ln_a, wo)
    if et.has_directional:
        # directional: a disk of the scene's radius at its bound
        is_dir = etype == ET_DIRECTIONAL
        e_dir = row[..., C_DIR].expand(y_a.shape)
        R = et.scene_radius
        disk = warps.concentric_disk(u4[..., 0:2]) * R
        frd = frame_mod.build_orthogonal_frame(e_dir)
        y_dir = -2.0 * R * frd.n + disk[..., 0:1] * frd.t \
            + disk[..., 1:2] * frd.b
        d3 = is_dir[..., None]
        y = torch.where(d3, y_dir, y)
        wo = torch.where(d3, e_dir, wo)
        ln = torch.where(d3, frd.n, ln)
        pdf_area = torch.where(is_dir, 1.0 / (math.pi * R * R), pdf_area)
        pdf_dir = torch.where(is_dir, one, pdf_dir)
    # emitted power per (area × solid angle × wavenumber): area L·cosθ,
    # point and spot I (per sr, the spot's × its falloff), directional E
    # (per area)
    cos_e = vec.dot(wo, ln).abs()
    Le = torch.where(is_area, spec_val * cos_e, spec_val)
    if et.has_spot:
        Le = torch.where(is_spot, spec_val
                         * _spot_falloff_row(row, wo_sp_loc[..., 2]), Le)
    weight = Le / (pdf_area * pdf_dir).clamp_min(1e-30)
    return dict(y=y, ln=ln, wo=wo, weight=weight, pdf_area=pdf_area,
                pdf_dir=pdf_dir, valid=weight > 0)


def pdf_emission_dir(et: EmitterTable, emitter_id, ln, wo):
    """Directional density of sample_emission at an emitter vertex
    (solid-angle measure): area = cosine hemisphere, point = uniform
    sphere, spot = uniform cone, directional = delta (0)."""
    eid = emitter_id.clamp_min(0).long()
    etype = et.etype[eid]
    cos_e = vec.dot(ln, wo)
    zero = torch.zeros_like(cos_e)
    pdf = torch.where(etype == ET_POINT, zero + 1.0 / (4.0 * math.pi), zero)
    if et.has_spot:
        cosc = et.cos_cutoff[eid]
        sa_cut = 2.0 * math.pi * (1.0 - cosc)
        in_cone = vec.dot(et.dir[eid], wo) >= cosc
        pdf = torch.where((etype == ET_SPOT) & in_cone,
                          1.0 / sa_cut.clamp_min(1e-9), pdf)
    pdf = torch.where(etype == ET_AREA, cos_e.clamp_min(0.0) / math.pi, pdf)
    return torch.where(emitter_id >= 0, pdf, zero)
