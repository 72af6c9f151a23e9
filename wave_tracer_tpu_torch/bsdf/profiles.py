"""Wave-aware surface profiles: dirac, gaussian, fractal (K-correlation).

Port of wave_tracer_tpu/bsdf/profiles.py. A profile's power spectral
density (PSD) drives first-order SPM scatter and the Rayleigh specular
fraction α(k). Roughness parameters keep millimetre-based units (T in mm²,
σ in 1/mm, k·mm products); wavenumbers enter in SI rad/m and are
converted here. The fractal sampler is the importance strategy of
Holzschuch & Pacanowski 2017; the gaussian profile reuses it with γ = 40.
All functions are elementwise over (...,) tensors.
"""

from __future__ import annotations

import math

import torch

INV_TWO_PI = 1.0 / (2.0 * math.pi)
INV_PI = 1.0 / math.pi
# mean wavenumber 2π/550nm in 1/mm
MEANK_MM = 2.0 * math.pi / 550e-9 * 1e-3
MAX_GGX_ALPHA = 0.75
MAX_T = 70.0 ** 2    # mm²

PROFILE_DIRAC = 0
PROFILE_GAUSSIAN = 1
PROFILE_FRACTAL = 2


def k_mm(k_si):
    """SI wavenumber [rad/m] → 1/mm."""
    return k_si * 1e-3


def roughness_to_T(alpha):
    """GGX-matched perceptual roughness → correlation area T [mm²]."""
    a2 = alpha.clamp(0.0, MAX_GGX_ALPHA) ** 2
    return torch.clamp_max((1.0 - a2) / (4.0 * MEANK_MM ** 2
                                         * a2.clamp_min(1e-12)), MAX_T)


def roughness_to_alpha_param(alpha):
    """Roughness → Rayleigh α parameter."""
    return (alpha / 9.0) ** 2


class ProfileParams:
    """Per-lane profile parameters (SoA): all (...,) tensors."""

    def __init__(self, ptype, T, alpha_param, gamma, sigma2_norm):
        self.ptype = ptype            # i32: 0 dirac / 1 gaussian / 2 fractal
        self.T = T                    # mm² (gaussian: 1/σ²)
        self.alpha_param = alpha_param
        self.gamma = gamma
        self.sigma2_norm = sigma2_norm


def sigma2_normalization(ptype, T, gamma, k_si):
    """1/(1 − (1 + k²T)^−(γ−1)/2) (fractal), 1/(1 − exp(−k²T/2))
    (gaussian, T = 1/σ²)."""
    km = k_mm(k_si)
    p_frac = torch.pow(1.0 + km * km * T, 0.5 * (gamma - 1.0))
    norm_frac = 1.0 / (1.0 - 1.0 / p_frac.clamp_min(1.0 + 1e-9)
                       ).clamp_min(1e-9)
    sigma2 = 1.0 / T.clamp_min(1e-12)
    norm_gauss = 1.0 / (1.0 - torch.exp(
        -0.5 * km * km / sigma2.clamp_min(1e-12))).clamp_min(1e-9)
    return torch.where(ptype == PROFILE_GAUSSIAN, norm_gauss, norm_frac)


def make_params(ptype, roughness, gamma, k_si, T_direct=None,
                sigmah=None):
    """Profile parameters at wavenumber k: from the perceptual roughness,
    or from the direct (T, σ_h) parameterization when T_direct is given."""
    if T_direct is None:
        T = roughness_to_T(roughness)
        alpha_param = roughness_to_alpha_param(roughness)
    else:
        T = T_direct
        alpha_param = sigmah ** 2
    return ProfileParams(ptype, T, alpha_param, gamma,
                         sigma2_normalization(ptype, T, gamma, k_si))


def alpha_specular(params: ProfileParams, wi_z, wo_z, k_si):
    """Specular (coherent) fraction: the Rayleigh roughness factor
    exp(−((|wi.z|+|wo.z|)·k·σ_h)²); 1 for dirac."""
    km = k_mm(k_si)
    a = ((wi_z.abs() + wo_z.abs()) * km) ** 2 * params.alpha_param
    return torch.where(params.ptype == PROFILE_DIRAC, 1.0, torch.exp(-a))


def psd(params: ProfileParams, z2, k_si):
    """PSD at squared spatial frequency |z|² [1/mm²]; z = k(wi⊥+wo⊥)."""
    km = k_mm(k_si)
    x = 1.0 + params.T * z2
    pf = torch.pow(x.clamp_min(1e-12), 0.5 * (params.gamma + 1.0))
    f_frac = (params.gamma - 1.0) * params.T / pf.clamp_min(1e-12)
    sigma2 = (1.0 / params.T.clamp_min(1e-12)).clamp_min(1e-12)
    f_gauss = torch.exp(-0.5 * z2 / sigma2) / sigma2
    f = torch.where(params.ptype == PROFILE_GAUSSIAN, f_gauss, f_frac)
    out = params.sigma2_norm * INV_TWO_PI * km * km * f
    return torch.where(params.ptype == PROFILE_DIRAC, 0.0, out)


def psd_dirs(params: ProfileParams, wi, wo, k_si):
    """PSD for local directions wi, wo (both (..., 3))."""
    km = k_mm(k_si)
    zx = km * (wi[..., 0] + wo[..., 0])
    zy = km * (wi[..., 1] + wo[..., 1])
    return psd(params, zx * zx + zy * zy, k_si)


def _phi_max(f_k, s):
    """Azimuthal truncation: directions stay on the unit disk. The cosine
    is clipped strictly inside (−1, 1)."""
    degenerate = (f_k < 1e-9) | (s < 1e-9)
    c = ((f_k ** 2 + s ** 2 - 1.0) / (2.0 * f_k * s).clamp_min(1e-12)
         ).clamp(-1.0 + 1e-6, 1.0 - 1e-6)
    return torch.where(degenerate, math.pi, torch.arccos(c))


def sample(params: ProfileParams, wi, k_si, u2):
    """Sample a scattered direction from the profile. wi local (..., 3),
    u2 (..., 2). Returns (wo, pdf, psd_val, valid)."""
    km = k_mm(k_si)
    s = torch.sqrt((1.0 - wi[..., 2] ** 2).clamp_min(1e-24))
    phi_i = torch.atan2(wi[..., 1], wi[..., 0])
    gamma = torch.where(params.ptype == PROFILE_GAUSSIAN, 40.0, params.gamma)
    T = params.T
    sqrtT = torch.sqrt(T.clamp_min(1e-12))

    k2T = km * km * T
    M = 1.0 - torch.pow(1.0 + k2T * (1.0 + s) ** 2, -0.5 * (gamma - 1.0))
    # the floor keeps 1 − M·u > 0 as u → 1 in f32
    base = torch.pow((1.0 - M * u2[..., 0]).clamp_min(1e-12),
                     -2.0 / (gamma - 1.0))
    f = torch.sqrt((base - 1.0).clamp_min(1e-24)) / sqrtT   # 1/mm
    f_k = f / km

    pm = _phi_max(f_k, s)
    phi_f = phi_i + (2.0 * u2[..., 1] - 1.0) * pm
    vfx = f * torch.cos(phi_f)
    vfy = f * torch.sin(phi_f)

    # ζ = k(wi⊥+wo⊥) ⇒ wo⊥ = ζ/k − wi⊥
    wox = vfx / km - wi[..., 0]
    woy = vfy / km - wi[..., 1]
    wo2 = wox * wox + woy * woy
    valid = wo2 < 1.0
    z = torch.sqrt((1.0 - wo2).clamp_min(1e-24))
    z = torch.where(wi[..., 2] >= 0, z, -z)
    wo = torch.stack([wox, woy, z], dim=-1)

    psd_val = psd(params, vfx * vfx + vfy * vfy, k_si)
    w = INV_PI * pm
    pdfv = torch.where(w > 1e-2, z.abs() * psd_val / w.clamp_min(1e-2),
                       0.0)
    return wo, pdfv, psd_val, valid & (pdfv > 0)


def pdf(params: ProfileParams, wi, wo, k_si):
    """Sampling density of `sample` for (wi, wo)."""
    zeta_kx = wi[..., 0] + wo[..., 0]
    zeta_ky = wi[..., 1] + wo[..., 1]
    f_k = torch.sqrt(zeta_kx ** 2 + zeta_ky ** 2)
    s = torch.sqrt((1.0 - wi[..., 2] ** 2).clamp_min(0.0))
    pm = _phi_max(f_k, s)
    psd_val = psd_dirs(params, wi, wo, k_si)
    w = INV_PI * pm
    return torch.where(w > 1e-2, wo[..., 2].abs() * psd_val
                       / w.clamp_min(1e-2), 0.0)
