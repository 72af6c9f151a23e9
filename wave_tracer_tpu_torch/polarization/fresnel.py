"""Complex Fresnel coefficients at an interface — batched torch.

Port of wave_tracer_tpu/polarization/fresnel.py. ``eta12`` is the
refractive-index ratio η1/η2 (incident/transmitted medium); the incident
direction ``w`` points away from the surface; ``n`` is the surface normal
on the incident side. Complex amplitudes are complex64. Squares of complex
values are products (not `pow`), as the JAX package lowers them, so both
packages take the same branch of the complex square root.
"""

from __future__ import annotations

import torch

from wave_tracer_tpu_torch.math import vec


def refract_dir(eta12, w, n):
    """Refracted direction; w away from the surface, eta12 real. Returns
    (t, cos θt, oriented η, total internal reflection)."""
    wn = vec.dot(w, n)
    eta = torch.where(wn > 0, eta12, 1.0 / eta12)
    cost2 = 1.0 - eta ** 2 * (1.0 - wn ** 2)
    tir = cost2 < 0.0
    # the floor keeps the derivatives of sqrt and of |ct/(η·ci)| finite on
    # the total-internal-reflection rows, which `fresnel` masks
    cost = torch.sqrt(cost2.clamp_min(1e-30))
    nsgn = torch.where(wn >= 0, 1.0, -1.0)[..., None] * n
    t = eta[..., None] * (wn[..., None] * n - w) - cost[..., None] * nsgn
    t = vec.normalize(t, eps=1e-24)
    up = torch.zeros_like(t)
    up[..., 2] = 1.0
    t = torch.where(tir[..., None], up, t)
    return t, cost, eta, tir


def fresnel(eta12, w, n):
    """Full dielectric Fresnel. eta12: complex ratio η1/η2 (...,).
    Returns dict with t (refracted dir), eta (oriented ratio), Z
    (impedance factor), rs, rp, ts, tp (complex amplitudes), Ts, Tp (power
    transmittances; 0 on TIR) and tir (grazing or TIR: full reflection)."""
    eta12 = eta12.to(torch.complex64)
    wn = vec.dot(w, n)
    abs_cosi = wn.abs()
    t, cost, _, tir = refract_dir(eta12.real, w, n)
    # oriented ratio: 1/eta when entering from the back side
    eta = torch.where(wn > 0, eta12, 1.0 / eta12)

    ci = abs_cosi.to(torch.complex64)
    ct = cost.to(torch.complex64)
    rs = (eta * ci - ct) / (eta * ci + ct)
    rp = (ci - eta * ct) / (ci + eta * ct)
    ts = rs + 1.0
    tp = (rp + 1.0) * eta

    # 1e-15, not 1e-30: the divisor's square stays a normal f32 on the
    # grazing rows (ci = 0), whose masked-off Z then back-propagates 0
    Z = (ct / (eta * ci + 1e-15)).abs()
    Ts = torch.clamp_max(Z * ts.abs() ** 2, 1.0)
    Tp = torch.clamp_max(Z * tp.abs() ** 2, 1.0)

    bad = tir | (abs_cosi == 0.0)
    one = torch.ones_like(rs)
    zero = torch.zeros_like(rs)
    return dict(t=t, eta=eta, Z=torch.where(bad, 1.0, Z),
                rs=torch.where(bad, one, rs), rp=torch.where(bad, one, rp),
                ts=torch.where(bad, zero, ts), tp=torch.where(bad, zero, tp),
                Ts=torch.where(bad, 0.0, Ts), Tp=torch.where(bad, 0.0, Tp),
                tir=bad)


def fresnel_reflection_conductor(eta12, w, n):
    """Reflection-only Fresnel for conductors (complex η ratio). Returns
    (rs, rp); zero for w behind the surface."""
    eta12 = eta12.to(torch.complex64)
    wn = vec.dot(w, n)
    i = wn.to(torch.complex64)
    t = torch.sqrt(1.0 - (1.0 - wn ** 2).to(torch.complex64)
                   * (eta12 * eta12))
    rs = (eta12 * i - t) / (eta12 * i + t)
    rp = (i - eta12 * t) / (i + eta12 * t)
    back = wn < 0
    zero = torch.zeros_like(rs)
    return torch.where(back, zero, rs), torch.where(back, zero, rp)
