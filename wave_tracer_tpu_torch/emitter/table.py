"""Device emitter table: NEE sampling, emission evaluation, pdfs.

Port of wave_tracer_tpu/emitter/table.py for area and point emitters:
NEE (`sample_direct`), emission (`emission_radiance`), emitted-ray
sampling for light subpaths (`sample_emission`) and their pdfs.
The bake keeps the JAX package's (E, 20) pack layout and its concatenated
per-emitter triangle CDF (triangle indices in the device triangle order
of the GeoArrays the table is used with).
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
C_COS_CUTOFF = 8
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
    dir: torch.Tensor         # (E, 3) propagation direction (spot)
    cos_cutoff: torch.Tensor  # (E,) (spot; 1 for area and point)
    pse_scale: torch.Tensor   # (E,) phase_space_extent_scale

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
        else:
            raise NotImplementedError(
                f"emitter {type(em).__name__} is not ported yet")
        power[i] = em.power()

    etri_idx = np.concatenate(idx_list) if idx_list \
        else np.zeros(1, np.int32)
    etri_cdf = np.concatenate(cdf_list) if cdf_list \
        else np.ones(1, np.float32)
    edir = np.tile(np.array([0, 0, 1], np.float32), (E, 1))
    cosc = np.ones(E, np.float32)
    pack = np.zeros((E, 20), np.float32)
    pack[:, C_ETYPE] = etype
    pack[:, C_POS] = pos
    pack[:, C_DIR] = edir
    pack[:, 7] = 1.0              # cos_beam   (spot; unused here)
    pack[:, C_COS_CUTOFF] = cosc
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
    contribution already including 1/d² for point emitters), pdf_sa
    (solid-angle density; 1 for delta lobes), delta_dir, y (light point),
    ln (light normal), valid, tri (light triangle or -1)."""
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

    # point (delta position): I(k)/d²
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
    uniform position and cosine direction; point: uniform sphere). Returns
    dict with position y, normal ln, direction wo, weight (spectral power
    per unit pdf), pdf_area, pdf_dir, valid."""
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
    ln = torch.where(a3, ln_a, wo)
    pdf_area = torch.where(is_area, pdf_area_a, one)
    pdf_dir = torch.where(is_area, pdf_dir_a,
                          one * warps.uniform_sphere_pdf())
    # emitted power per (area × solid angle × wavenumber): area L·cosθ,
    # point I (per sr)
    cos_e = vec.dot(wo, ln).abs()
    Le = torch.where(is_area, spec_val * cos_e, spec_val)
    weight = Le / (pdf_area * pdf_dir).clamp_min(1e-30)
    return dict(y=y, ln=ln, wo=wo, weight=weight, pdf_area=pdf_area,
                pdf_dir=pdf_dir, valid=weight > 0)


def pdf_emission_dir(et: EmitterTable, emitter_id, ln, wo):
    """Directional density of sample_emission at an emitter vertex
    (solid-angle measure): area = cosine hemisphere, point = uniform
    sphere."""
    eid = emitter_id.clamp_min(0).long()
    etype = et.etype[eid]
    cos_e = vec.dot(ln, wo)
    zero = torch.zeros_like(cos_e)
    pdf = torch.where(etype == ET_AREA, cos_e.clamp_min(0.0) / math.pi,
                      torch.where(etype == ET_POINT,
                                  zero + 1.0 / (4.0 * math.pi), zero))
    return torch.where(emitter_id >= 0, pdf, zero)
