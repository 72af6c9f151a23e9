"""Device BSDF dispatch: batched sample / eval over the material table.

Port of wave_tracer_tpu/bsdf/device.py for the diffuse, surface_spm and
null lobes, including the `twosided` back-face flip. Directions are in the
local shading frame (z = shading normal), pointing away from the surface:
* `eval_f` returns the Mueller-valued BSDF including the |wo.z| cosine;
* `sample` returns wo, its density and the weighted bsdf Mw = M/pdf.
Dispatch is compute-all-select by material type, in the JAX module's
order; a table without surface_spm rows (`MaterialTable.has_spm`) skips
that lobe's arithmetic. Dielectric rows never reach here: baking or
bridging one raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from wave_tracer_tpu_torch.bsdf import profiles
from wave_tracer_tpu_torch.bsdf.table import (
    C_EXT_IOR, C_IOR, C_MTYPE, C_PROF_GAMMA, C_PROF_ROUGH_TEX, C_PROF_SIGMAH,
    C_PROF_T, C_PROF_TYPE, C_REFL_TEX, C_RSCALE, C_SCALE, C_TSCALE,
    C_TWOSIDED, MT_DIFFUSE, MT_NULL, MT_SPM, MaterialTable)
from wave_tracer_tpu_torch.polarization import fresnel as fr
from wave_tracer_tpu_torch.polarization import mueller
from wave_tracer_tpu_torch.sampling import warps
from wave_tracer_tpu_torch.spectrum.bake import (ComplexSpectrumTable,
                                                 SpectrumTable)
from wave_tracer_tpu_torch.texture.texture import (TextureTable,
                                                   eval_texture_scalar)

INV_PI = 1.0 / math.pi


@dataclass
class Tables:
    """All device lookup tables needed for material evaluation."""
    materials: MaterialTable
    textures: TextureTable
    spectra: SpectrumTable
    cspectra: ComplexSpectrumTable


@dataclass
class BsdfSample:
    wo: torch.Tensor         # (N, 3) local
    pdf: torch.Tensor        # (N,)
    Mw: torch.Tensor         # (N, 4, 4) weighted bsdf M/pdf
    specular: torch.Tensor   # (N,) bool — discrete (delta) lobe
    eta: torch.Tensor        # (N,) real oriented η ratio (1: no refraction)
    refracted: torch.Tensor  # (N,) bool
    valid: torch.Tensor      # (N,) bool


def _mtype(row, mat_id):
    return torch.where(mat_id >= 0, row[:, C_MTYPE].to(torch.int32),
                       torch.full_like(mat_id, MT_NULL, dtype=torch.int32))


def _row_and_frame(tables: Tables, mat_id, wi):
    """Material row, effective type and the twosided sign flip."""
    row = tables.materials.pack[mat_id.clamp_min(0).long()]
    flip = (row[:, C_TWOSIDED] > 0.5) & (wi[..., 2] < 0.0)
    sgn = torch.where(flip, -1.0, 1.0).to(wi.dtype)
    return row, _mtype(row, mat_id), sgn


def _flip_z(w, sgn):
    return torch.cat([w[..., :2], (w[..., 2] * sgn)[..., None]], dim=-1)


def _reflectance(tables, row, uv, k):
    return eval_texture_scalar(tables.textures, tables.spectra,
                               row[:, C_REFL_TEX].to(torch.int32), uv,
                               k).clamp(0.0, 1.0)


def _local_z(like):
    z = torch.zeros_like(like)
    z[..., 2] = 1.0
    return z


def _ior_ratio(tables: Tables, ior_id, ext_ior_id, k):
    """η1/η2 = ext/int at wavenumber k (−1 rows: vacuum, η = 1)."""
    one = torch.ones((), dtype=torch.complex64, device=k.device)
    eta2 = torch.where(ior_id >= 0, tables.cspectra.eval(ior_id, k), one)
    eta1 = torch.where(ext_ior_id >= 0, tables.cspectra.eval(ext_ior_id, k),
                       one)
    return eta1 / eta2


def _spec_or_one(tables: Tables, sid, k):
    return torch.where(sid >= 0, tables.spectra.eval(sid, k), 1.0)


def _profile_params(tables: Tables, row, uv, k):
    """The row's surface profile at (uv, k): roughness-textured rows use
    roughness_to_T, the others their direct (T, σh)."""
    ptype = row[:, C_PROF_TYPE].to(torch.int32)
    rough_tex = row[:, C_PROF_ROUGH_TEX].to(torch.int32)
    gamma = row[:, C_PROF_GAMMA]
    rough = eval_texture_scalar(tables.textures, tables.spectra, rough_tex,
                                uv, k)
    has_rough = rough_tex >= 0
    T = torch.where(has_rough, profiles.roughness_to_T(rough),
                    row[:, C_PROF_T])
    sigmah = torch.where(has_rough, 0.0, row[:, C_PROF_SIGMAH])
    alpha_param = torch.where(has_rough,
                              profiles.roughness_to_alpha_param(rough),
                              sigmah ** 2)
    return profiles.ProfileParams(
        ptype, T, alpha_param, gamma,
        profiles.sigma2_normalization(ptype, T, gamma, k))


def _flip_wo(wo, eta_r):
    """Map a reflected direction to the refracted side, Snell-scaling the
    transverse components. Returns (wo', ok)."""
    scale = torch.where(wo[..., 2] < 0, eta_r, 1.0 / eta_r.clamp_min(1e-9))
    xy = wo[..., :2] * scale[..., None]
    l2 = (xy * xy).sum(-1)
    z = torch.sqrt((1.0 - l2).clamp_min(0.0))
    z = torch.where(wo[..., 2] > 0, -z, z)
    out = torch.cat([xy, z[..., None]], dim=-1)
    bad = l2 > 1.0
    fallback = torch.zeros_like(out)
    fallback[..., 0] = 1.0
    return torch.where(bad[..., None], fallback, out), ~bad


def _has_transmission(eta12):
    """Conductors (|Im η|² > 1% of |η|²) do not transmit."""
    n2 = eta12.real ** 2 + eta12.imag ** 2
    return eta12.imag ** 2 / n2.clamp_min(1e-20) <= 1e-2


def _half_vector(wi_l, wo_l):
    """Microsurface normal of (wi, wo), on wi's side of the surface."""
    hsgn = torch.where(wi_l[..., 2] < 0, -1.0, 1.0)
    m = hsgn[..., None] * (wi_l + wo_l)
    return m / torch.linalg.vector_norm(m, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def _spm_sample(tables: Tables, row, wi_l, uv, k, u4, scale):
    """The surface_spm lobe of `sample`: (wo, pdf, Mw, specular,
    refracted, real oriented η, valid), all lanes."""
    i32 = torch.int32
    eta12 = _ior_ratio(tables, row[:, C_IOR].to(i32),
                       row[:, C_EXT_IOR].to(i32), k)
    n = _local_z(wi_l)
    fres = fr.fresnel(eta12, wi_l, n)
    T = 0.5 * (fres["Ts"] + fres["Tp"])
    rs_c, rp_c = fr.fresnel_reflection_conductor(eta12, wi_l, n)
    rscale = _spec_or_one(tables, row[:, C_RSCALE].to(i32), k) * scale
    tscale = _spec_or_one(tables, row[:, C_TSCALE].to(i32), k) * scale
    eta_r = fres["eta"].real
    J_bwd = eta_r ** 2     # backward-transport radiance compression
    wo_refl = torch.cat([-wi_l[..., :2], wi_l[..., 2:3]], dim=-1)

    prof = _profile_params(tables, row, uv, k)
    alpha = profiles.alpha_specular(prof, wi_l[..., 2], wi_l[..., 2], k)
    alpha = torch.where(prof.ptype == profiles.PROFILE_DIRAC, 1.0, alpha)
    has_trans = _has_transmission(eta12)
    is_spec = u4[..., 1] < alpha
    pdf_lobe = torch.where(is_spec, alpha, 1.0 - alpha)
    is_refl = torch.where(has_trans, u4[..., 0] >= T, True)
    pdf_spm = pdf_lobe * torch.where(
        has_trans, torch.where(is_refl, 1.0 - T, T), 1.0)
    Js = torch.where(is_refl, 1.0, J_bwd)
    sscale = torch.where(is_refl, rscale, tscale)
    r3, r33 = is_refl[..., None], is_refl[..., None, None]

    # specular branch
    wo_spec = torch.where(r3, wo_refl, fres["t"])
    M_spec = torch.where(
        r33, mueller.from_jones_sp(rs_c, rp_c, alpha * sscale),
        mueller.from_jones_sp(fres["ts"], fres["tp"],
                              fres["Z"] * alpha * Js * sscale))

    # scatter branch: profile sampling (same hemisphere), then the flip
    wo_sc, pdf_sc, psd_sc, ok_sc = profiles.sample(prof, wi_l, k,
                                                   u4[..., 2:4])
    m = _half_vector(wi_l, wo_sc)
    rs_h, rp_h = fr.fresnel_reflection_conductor(eta12, wi_l, m)
    fres_h = fr.fresnel(eta12, wi_l, m)
    a_s = torch.where(is_refl, rs_h, fres_h["ts"])
    a_p = torch.where(is_refl, rp_h, fres_h["tp"])
    Zh = torch.where(is_refl, 1.0, fres_h["Z"])
    wo_flip, flip_ok = _flip_wo(wo_sc, eta_r)
    wo_sc = torch.where(r3, wo_sc, wo_flip)
    Msc_scale = (1.0 - alpha) * Js * wo_sc[..., 2].abs() * psd_sc \
        * sscale * Zh
    M_sc = mueller.from_jones_sp(a_s, a_p, Msc_scale)
    ok_sc = ok_sc & (is_refl | flip_ok)

    pdf = pdf_spm * torch.where(is_spec, 1.0, pdf_sc)
    M = torch.where(is_spec[..., None, None], M_spec, M_sc)
    valid = (pdf > 1e-12) & (is_spec | ok_sc) & (wi_l[..., 2].abs() > 0)
    return dict(wo=torch.where(is_spec[..., None], wo_spec, wo_sc), pdf=pdf,
                Mw=M / pdf.clamp_min(1e-12)[..., None, None],
                specular=is_spec, refracted=~is_refl, eta_r=eta_r,
                valid=valid)


def sample(tables: Tables, mat_id, wi, uv, k, u4):
    """Sample all lanes' BSDFs. u4 (N, 4) uniforms: lobe pick (T/R),
    specular pick, direction pair. Returns BsdfSample."""
    row, mtype, sgn = _row_and_frame(tables, mat_id, wi)
    wi_l = _flip_z(wi, sgn)
    scale = row[:, C_SCALE]

    # diffuse
    refl = _reflectance(tables, row, uv, k)
    wo_d = warps.cosine_hemisphere(u4[..., 2:4])
    pdf_d = warps.cosine_hemisphere_pdf(wo_d[..., 2])
    Mw_d = mueller.depolarizer(refl * scale)
    valid_d = wi_l[..., 2] > 0.0

    # null (passthrough)
    wo_null = -wi_l
    Mw_null = mueller.identity(wi_l.shape[:-1], device=wi.device)

    is_d = mtype == MT_DIFFUSE
    one = torch.ones_like(pdf_d)
    wo = torch.where(is_d[..., None], wo_d, wo_null)
    Mw = torch.where(is_d[..., None, None], Mw_d, Mw_null)
    pdf = torch.where(is_d, pdf_d, one)
    specular = ~is_d
    valid = torch.where(is_d, valid_d, mat_id >= 0)
    refracted = torch.zeros_like(valid)
    eta = one
    if tables.materials.has_spm:
        spm = _spm_sample(tables, row, wi_l, uv, k, u4, scale)
        is_s = mtype == MT_SPM
        wo = torch.where(is_s[..., None], spm["wo"], wo)
        Mw = torch.where(is_s[..., None, None], spm["Mw"], Mw)
        pdf = torch.where(is_s, spm["pdf"], pdf)
        specular = torch.where(is_s, spm["specular"], specular)
        refracted = is_s & spm["refracted"]
        eta = torch.where(refracted, spm["eta_r"], one)
        valid = torch.where(is_s, spm["valid"], valid)
    return BsdfSample(wo=_flip_z(wo, sgn), pdf=pdf, Mw=Mw,
                      specular=specular, eta=eta, refracted=refracted,
                      valid=valid)


@dataclass
class MaterialAt:
    """What `eval_f` reads of a material at one surface point and
    wavenumber, whatever the directions: formed once by `material_at` for
    a vertex that many directions are evaluated at."""
    row: torch.Tensor        # (N, C) material row
    mtype: torch.Tensor      # (N,) i32 effective type
    refl: torch.Tensor       # (N,) diffuse reflectance at (uv, k)


def material_at(tables: Tables, mat_id, uv, k) -> MaterialAt:
    row = tables.materials.pack[mat_id.clamp_min(0).long()]
    return MaterialAt(row=row, mtype=_mtype(row, mat_id),
                      refl=_reflectance(tables, row, uv, k))


def _spm_eval(tables: Tables, row, wi_l, wo_l, uv, k, scale):
    """The surface_spm scatter lobe of `eval_f`: (M, pdf), all lanes."""
    i32 = torch.int32
    eta12 = _ior_ratio(tables, row[:, C_IOR].to(i32),
                       row[:, C_EXT_IOR].to(i32), k)
    eta_re = eta12.real
    eta_r_orient = torch.where(wi_l[..., 2] > 0, eta_re,
                               1.0 / eta_re.clamp_min(1e-9))
    has_trans = _has_transmission(eta12)
    is_refl = wi_l[..., 2] * wo_l[..., 2] >= 0.0
    abs_wo, flip_ok = _flip_wo(wo_l, eta_re)
    abs_wo = torch.where(is_refl[..., None], wo_l, abs_wo)
    prof = _profile_params(tables, row, uv, k)
    alpha_eval = profiles.alpha_specular(prof, wi_l[..., 2], abs_wo[..., 2],
                                         k)
    alpha_s = profiles.alpha_specular(prof, wi_l[..., 2], wi_l[..., 2], k)
    J = torch.where(is_refl, 1.0, eta_r_orient ** 2)
    rscale = _spec_or_one(tables, row[:, C_RSCALE].to(i32), k) * scale
    tscale = _spec_or_one(tables, row[:, C_TSCALE].to(i32), k) * scale
    sscale = torch.where(is_refl, rscale, tscale)
    m = _half_vector(wi_l, abs_wo)
    rs_h, rp_h = fr.fresnel_reflection_conductor(eta12, wi_l, m)
    fres_h = fr.fresnel(eta12, wi_l, m)
    a_s = torch.where(is_refl, rs_h, fres_h["ts"])
    a_p = torch.where(is_refl, rp_h, fres_h["tp"])
    Zh = torch.where(is_refl, 1.0, fres_h["Z"])
    psd_abs = profiles.psd_dirs(prof, wi_l, abs_wo, k)
    fmag = (1.0 - alpha_eval) * J * wo_l[..., 2].abs() * psd_abs \
        * sscale * Zh
    ok = (prof.ptype != profiles.PROFILE_DIRAC) \
        & (wi_l[..., 2].abs() > 0) & (wo_l[..., 2].abs() > 0) \
        & (is_refl | has_trans) & (is_refl | flip_ok)
    M = mueller.from_jones_sp(a_s, a_p, torch.where(ok, fmag, 0.0))
    # pdf: lobe prob (1 − αs) × T/R prob × profile pdf
    fres = fr.fresnel(eta12, wi_l, _local_z(wi_l))
    T = 0.5 * (fres["Ts"] + fres["Tp"])
    prob_tr = torch.where(has_trans, torch.where(is_refl, 1.0 - T, T), 1.0)
    pdf = torch.where(ok, (1.0 - alpha_s) * prob_tr
                      * profiles.pdf(prof, wi_l, abs_wo, k), 0.0)
    return M, pdf


def eval_f(tables: Tables, mat_id, wi, wo, uv, k, at: MaterialAt = None):
    """Evaluate the non-delta lobes: returns (M (N,4,4), pdf (N,)). M
    includes the |wo.z| cosine; pdf is the density `sample` would have for
    (wi → wo), for MIS. The null lobe is a delta: M = 0, pdf = 0. `at`:
    the material at (mat_id, uv, k) from `material_at`, if formed."""
    if at is None:
        at = material_at(tables, mat_id, uv, k)
    row, mtype, refl = at.row, at.mtype, at.refl
    flip = (row[:, C_TWOSIDED] > 0.5) & (wi[..., 2] < 0.0)
    sgn = torch.where(flip, -1.0, 1.0).to(wi.dtype)
    wi_l = _flip_z(wi, sgn)
    wo_l = _flip_z(wo, sgn)
    scale = row[:, C_SCALE]
    both_up = (wi_l[..., 2] > 0) & (wo_l[..., 2] > 0) & (mtype == MT_DIFFUSE)
    zero = torch.zeros_like(refl)
    f_d = torch.where(both_up, wo_l[..., 2] * INV_PI * refl * scale, zero)
    pdf = torch.where(both_up, warps.cosine_hemisphere_pdf(wo_l[..., 2]),
                      zero)
    M = mueller.depolarizer(f_d)
    if tables.materials.has_spm:
        M_spm, pdf_spm = _spm_eval(tables, row, wi_l, wo_l, uv, k, scale)
        is_s = mtype == MT_SPM
        M = torch.where(is_s[..., None, None], M_spm, M)
        pdf = torch.where(is_s, pdf_spm, pdf)
    return M, pdf


def apply_normalmap(tables: Tables, mat_id, uv, k, sf):
    """Normal maps are not ported yet (baking one raises), so the shading
    frame passes through unchanged."""
    return sf
