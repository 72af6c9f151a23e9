"""Device BSDF dispatch: batched sample / eval over the material table.

Port of wave_tracer_tpu/bsdf/device.py: the diffuse, dielectric,
surface_spm and null lobes, composite materials (resolved to the child
row of the lane's wavenumber before the row gather), the `twosided`
back-face flip, opacity masks and normal maps. Directions are in the
local shading frame (z = shading normal), pointing away from the surface:
* `eval_f` returns the Mueller-valued BSDF including the |wo.z| cosine;
* `sample` returns wo, its density and the weighted bsdf Mw = M/pdf.
`duv`, where given, is the uv-space footprint diameter that selects the
mip level of bitmap reflectances. Dispatch is compute-all-select by
material type; a lobe or wrapper that no row of the table uses
(`MaterialTable.has_*`) makes no launch, and every result equals that of
the JAX module's full selection.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from wave_tracer_tpu_torch.bsdf import profiles
from wave_tracer_tpu_torch.bsdf.table import (
    C_EXT_IOR, C_IOR, C_MTYPE, C_NORMALMAP_TEX, C_OPACITY_TEX, C_PROF_GAMMA,
    C_PROF_ROUGH_TEX, C_PROF_SIGMAH, C_PROF_T, C_PROF_TYPE, C_REFL_TEX,
    C_RSCALE, C_SCALE, C_TSCALE, C_TWOSIDED, MT_DIELECTRIC, MT_DIFFUSE,
    MT_NULL, MT_SPM, MaterialTable)
from wave_tracer_tpu_torch.math import frame as frame_mod
from wave_tracer_tpu_torch.polarization import fresnel as fr
from wave_tracer_tpu_torch.polarization import mueller
from wave_tracer_tpu_torch.sampling import warps
from wave_tracer_tpu_torch.spectrum.bake import (ComplexSpectrumTable,
                                                 SpectrumTable)
from wave_tracer_tpu_torch.texture.texture import (TextureTable,
                                                   eval_texture_rgb,
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


def _row(tables: Tables, mat_id, k):
    """The material row of each lane at its wavenumber (composites
    resolved to their child) and its effective type."""
    eff = tables.materials.resolve(mat_id, k)
    row = tables.materials.pack[eff.clamp_min(0).long()]
    return row, _mtype(row, mat_id)


def _twosided_sign(row, wi):
    flip = (row[:, C_TWOSIDED] > 0.5) & (wi[..., 2] < 0.0)
    return torch.where(flip, -1.0, 1.0).to(wi.dtype)


def _flip_z(w, sgn):
    return torch.cat([w[..., :2], (w[..., 2] * sgn)[..., None]], dim=-1)


def _reflectance(tables, row, uv, k, duv=None):
    return eval_texture_scalar(tables.textures, tables.spectra,
                               row[:, C_REFL_TEX].to(torch.int32), uv,
                               k, duv).clamp(0.0, 1.0)


def _opacity(tables, row, uv, k):
    """The mask's opacity in [0, 1] (1 on rows without a mask)."""
    tex = row[:, C_OPACITY_TEX].to(torch.int32)
    op = eval_texture_scalar(tables.textures, tables.spectra, tex, uv,
                             k).clamp(0.0, 1.0)
    return torch.where(tex >= 0, op, 1.0)


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


def _interface(tables: Tables, row, wi_l, k, scale):
    """What the dielectric and surface_spm lobes of `sample` share: the
    Fresnel terms at the shading normal, the scale spectra and the
    mirror direction, all lanes."""
    i32 = torch.int32
    eta12 = _ior_ratio(tables, row[:, C_IOR].to(i32),
                       row[:, C_EXT_IOR].to(i32), k)
    n = _local_z(wi_l)
    fres = fr.fresnel(eta12, wi_l, n)
    eta_r = fres["eta"].real
    return dict(
        eta12=eta12, n=n, fres=fres, T=0.5 * (fres["Ts"] + fres["Tp"]),
        rscale=_spec_or_one(tables, row[:, C_RSCALE].to(i32), k) * scale,
        tscale=_spec_or_one(tables, row[:, C_TSCALE].to(i32), k) * scale,
        eta_r=eta_r,
        J_bwd=eta_r ** 2,     # backward-transport radiance compression
        wo_refl=torch.cat([-wi_l[..., :2], wi_l[..., 2:3]], dim=-1))


def _dielectric_sample(it, u4):
    """The dielectric lobe of `sample`, a delta: Fresnel-weighted choice
    between the mirror and the refracted direction (full reflection under
    total internal reflection), all lanes."""
    fres, T = it["fres"], it["T"]
    is_refl = u4[..., 0] >= T
    pdf = torch.where(is_refl, 1.0 - T, T)
    M_refl = mueller.from_jones_sp(fres["rs"], fres["rp"], it["rscale"])
    M_trans = mueller.from_jones_sp(fres["ts"], fres["tp"],
                                    fres["Z"] * it["tscale"] * it["J_bwd"])
    Mw = torch.where(is_refl[..., None, None], M_refl, M_trans) \
        / pdf.clamp_min(1e-9)[..., None, None]
    return dict(wo=torch.where(is_refl[..., None], it["wo_refl"], fres["t"]),
                pdf=pdf, Mw=Mw, specular=torch.ones_like(is_refl),
                refracted=~is_refl, valid=pdf > 1e-7)


def _spm_sample(tables: Tables, row, wi_l, uv, k, u4, it):
    """The surface_spm lobe of `sample`: (wo, pdf, Mw, specular,
    refracted, valid), all lanes."""
    eta12, fres, T = it["eta12"], it["fres"], it["T"]
    rs_c, rp_c = fr.fresnel_reflection_conductor(eta12, wi_l, it["n"])
    rscale, tscale = it["rscale"], it["tscale"]
    eta_r, J_bwd, wo_refl = it["eta_r"], it["J_bwd"], it["wo_refl"]

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
                specular=is_spec, refracted=~is_refl, valid=valid)


# f32 constants of the mask's golden-ratio mix
_MIX0 = float(np.float32(0.618034))
_MIX1 = float(np.float32(0.381966))


def mask_uniform(u4):
    """The opacity mask's uniform: a golden-ratio mix of two draws,
    decorrelated from the lobe picks, (u0·0.618034 + u3·0.381966) mod 1,
    rounded as the JAX package's compiled kernel rounds it: XLA contracts
    the sum into one fused multiply-add, u0·c0 + f32(u3·c1) rounded once.
    Here it is formed in float64, where u0·c0 is exact; the float64 sum
    can round differently from the fused one only at an f32 tie."""
    prod = (u4[..., 3] * _MIX1).to(torch.float64)
    mix = (u4[..., 0].to(torch.float64) * _MIX0 + prod).to(torch.float32)
    return mix % 1.0


def sample(tables: Tables, mat_id, wi, uv, k, u4, duv=None):
    """Sample all lanes' BSDFs. u4 (N, 4) uniforms: the lobe pair (T/R
    pick, specular pick), then the direction pair; the mask's uniform
    mixes u4[0] and u4[3]. Returns BsdfSample."""
    mat = tables.materials
    row, mtype = _row(tables, mat_id, k)
    sgn = _twosided_sign(row, wi)
    wi_l = _flip_z(wi, sgn)
    scale = row[:, C_SCALE]

    # diffuse
    refl = _reflectance(tables, row, uv, k, duv)
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
    if mat.has_dielectric or mat.has_spm:
        it = _interface(tables, row, wi_l, k, scale)
        lobes = []
        if mat.has_dielectric:
            lobes.append((mtype == MT_DIELECTRIC,
                          _dielectric_sample(it, u4)))
        if mat.has_spm:
            lobes.append((mtype == MT_SPM,
                          _spm_sample(tables, row, wi_l, uv, k, u4, it)))
        for is_l, lobe in lobes:
            wo = torch.where(is_l[..., None], lobe["wo"], wo)
            Mw = torch.where(is_l[..., None, None], lobe["Mw"], Mw)
            pdf = torch.where(is_l, lobe["pdf"], pdf)
            specular = torch.where(is_l, lobe["specular"], specular)
            refracted = torch.where(is_l, lobe["refracted"], refracted)
            valid = torch.where(is_l, lobe["valid"], valid)
        eta = torch.where(refracted, it["eta_r"], one)
    if mat.has_mask:
        # with probability 1 − opacity the surface is passed through
        # (weight 1, a delta lobe); otherwise the inner sample stands, its
        # pdf scaled by the opacity
        opacity = _opacity(tables, row, uv, k)
        u_mask = mask_uniform(u4)
        has_mask = row[:, C_OPACITY_TEX] >= 0
        through = (u_mask >= opacity) & has_mask
        wo = torch.where(through[..., None], wo_null, wo)
        Mw = torch.where(through[..., None, None], Mw_null, Mw)
        pdf = torch.where(through, (1.0 - opacity).clamp_min(1e-6),
                          torch.where(has_mask, pdf * opacity, pdf))
        specular = specular | through
        refracted = refracted & ~through
        valid = valid | through
    # detached sampling, as in the JAX package: the sampled direction,
    # its density and η carry no gradient (nor tangent); the radiometric
    # derivative flows through Mw only. This keeps gradients finite at
    # TIR and grazing angles, where d(direction)/d(IOR) diverges
    return BsdfSample(wo=_flip_z(wo, sgn).detach(), pdf=pdf.detach(), Mw=Mw,
                      specular=specular, eta=eta.detach(),
                      refracted=refracted, valid=valid)


@dataclass
class MaterialAt:
    """What `eval_f` reads of a material at one surface point and
    wavenumber, whatever the directions: formed once by `material_at` for
    a vertex that many directions are evaluated at."""
    row: torch.Tensor        # (N, C) material row (composites resolved)
    mtype: torch.Tensor      # (N,) i32 effective type
    refl: torch.Tensor       # (N,) diffuse reflectance at (uv, k)
    opacity: torch.Tensor | None   # (N,) mask opacity (None: no masks)


def material_at(tables: Tables, mat_id, uv, k, duv=None) -> MaterialAt:
    row, mtype = _row(tables, mat_id, k)
    return MaterialAt(row=row, mtype=mtype,
                      refl=_reflectance(tables, row, uv, k, duv),
                      opacity=_opacity(tables, row, uv, k)
                      if tables.materials.has_mask else None)


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


def eval_f(tables: Tables, mat_id, wi, wo, uv, k, duv=None,
           at: MaterialAt = None):
    """Evaluate the non-delta lobes: returns (M (N,4,4), pdf (N,)). M
    includes the |wo.z| cosine; pdf is the density `sample` would have for
    (wi → wo), for MIS. The null and dielectric lobes are deltas: M = 0,
    pdf = 0. A mask scales both by its opacity. `at`: the material at
    (mat_id, uv, k, duv) from `material_at`, if formed."""
    if at is None:
        at = material_at(tables, mat_id, uv, k, duv)
    row, mtype, refl = at.row, at.mtype, at.refl
    sgn = _twosided_sign(row, wi)
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
    if at.opacity is not None:
        M = M * at.opacity[..., None, None]
        pdf = pdf * at.opacity
    return M, pdf


def apply_normalmap(tables: Tables, mat_id, uv, k, sf, duv=None):
    """Perturb a shading frame by the material's normal map (tangent-space
    RGB in [0, 1] → normal); lanes whose material has none keep `sf`."""
    if not tables.materials.has_normalmap:
        return sf
    eff = tables.materials.resolve(mat_id, k).clamp_min(0).long()
    tex = tables.materials.pack[eff, C_NORMALMAP_TEX].to(torch.int32)
    rgb = eval_texture_rgb(tables.textures, tables.spectra, tex, uv, duv)
    n_local = 2.0 * rgb - 1.0
    n_local = n_local / torch.linalg.vector_norm(
        n_local, dim=-1, keepdim=True).clamp_min(1e-6)
    perturbed = frame_mod.build_shading_frame(sf.to_world(n_local), sf.t)
    use = (tex >= 0)[..., None]
    return frame_mod.Frame(t=torch.where(use, perturbed.t, sf.t),
                           b=torch.where(use, perturbed.b, sf.b),
                           n=torch.where(use, perturbed.n, sf.n))


def vecz(v):
    return v[..., 2]
