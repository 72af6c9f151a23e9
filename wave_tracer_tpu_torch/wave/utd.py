"""UTD wedge diffraction, batched over (lane, edge) slots.

Port of wave_tracer_tpu/wave/utd.py: the a± functions, the transition
function F (math/special.py), Keller-cone Fermat diffraction points, and
the soft/hard wedge diffraction coefficients Ds/Dh with their four
cotangent terms. A wedge is: centre v, length l, front-face normal nff
and tangent tff (e = nff × tff), back-face normal nbf, interior angle α.
All tensors broadcast over batch shapes, typically (N, K).
"""

from __future__ import annotations

import math

import torch

from wave_tracer_tpu_torch.math import vec
from wave_tracer_tpu_torch.math.special import utd_transition

UTD_MIN_SIN_BETA = 1e-3
TWO_PI = 2.0 * math.pi
_D_PHASE = complex(math.cos(-math.pi / 4), math.sin(-math.pi / 4))


def floor_mod(x, y: float):
    """x mod y with the sign of y, computed as jnp.mod does: the exact
    truncated remainder, shifted by y where its sign differs from y's."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def edge_dir(nff, tff):
    """e = nff × tff."""
    return vec.cross(nff, tff)


def utd_a(sgn, phi, n):
    """The UTD a± function."""
    N = torch.round((sgn * math.pi + phi) / (TWO_PI * n))
    return 2.0 * torch.cos(math.pi * n * N - 0.5 * phi) ** 2


def fermat_point_to(v, e, tff, nff, half_l, src, dst):
    """Point on the edge line satisfying Fermat's principle for src→dst.
    Returns (p, valid)."""
    sv = src - v
    dv = dst - v
    sl = vec.safe_sqrt(vec.dot(sv, tff) ** 2 + vec.dot(sv, nff) ** 2)
    dl = vec.safe_sqrt(vec.dot(dv, tff) ** 2 + vec.dot(dv, nff) ** 2)
    t = vec.dot(e, sv) + vec.dot(dst - src, e) * sl \
        / (sl + dl).clamp_min(1e-30)
    valid = t.abs() <= half_l
    p = v + e * t[..., None]
    valid = valid & (vec.length2(p - src) > 1e-24) \
        & (vec.length2(p - dst) > 1e-24)
    return p, valid


def fermat_point_dir(v, e, tff, nff, half_l, src, wo):
    """Fermat point for src → direction wo. Returns (p, valid)."""
    cos_beta = vec.dot(wo, e)
    sin_beta = vec.safe_sqrt(1.0 - cos_beta ** 2, 1e-24)
    sv = src - v
    sl = vec.safe_sqrt(vec.dot(sv, tff) ** 2 + vec.dot(sv, nff) ** 2)
    prj = v + vec.dot(sv, e)[..., None] * e
    p = prj + (sl * cos_beta / sin_beta.clamp_min(1e-20))[..., None] * e
    valid = (sin_beta >= UTD_MIN_SIN_BETA) \
        & (vec.length2(p - v) <= half_l ** 2) \
        & (vec.length2(p - src) > 1e-24)
    return p, valid


def utd_coefficients(k, wi, wo, ro, e, tff, nff, alpha):
    """Soft/hard diffraction coefficients Ds, Dh (complex64).

    wi: unit direction from the diffraction point toward the source; wo:
    unit direction of outgoing propagation; ro: distance to the observer.
    Does not include the e^{-ikro} phase."""
    n = 2.0 - alpha / math.pi

    cos_bi = vec.dot(wi, e)
    sin_beta2 = (1.0 - cos_bi ** 2).clamp_min(0.0)
    sin_beta = vec.safe_sqrt(sin_beta2, 1e-24)
    phii = torch.atan2(vec.dot(nff, wi), vec.dot(tff, wi))
    phio = torch.atan2(vec.dot(nff, wo), vec.dot(tff, wo))

    Li = ro * sin_beta2

    def cot(x):
        s = torch.sin(x)
        return torch.cos(x) / torch.where(s.abs() < 1e-9, 1e-9, s)

    dphi = phii - phio
    sphi = phii + phio
    F1 = utd_transition(k * Li * utd_a(+1, dphi, n))
    F2 = utd_transition(k * Li * utd_a(-1, dphi, n))
    F3 = utd_transition(k * Li * utd_a(+1, sphi, n))
    F4 = utd_transition(k * Li * utd_a(-1, sphi, n))
    inv2n = 1.0 / (2.0 * n)
    D1 = -cot((math.pi + dphi) * inv2n) * F1
    D2 = -cot((math.pi - dphi) * inv2n) * F2
    D3 = -cot((math.pi + sphi) * inv2n) * F3
    D4 = -cot((math.pi - sphi) * inv2n) * F4

    kro = (k * ro).clamp_min(1e-20)
    D = (1.0 / (2.0 * n * torch.sqrt(kro)
                * sin_beta.clamp_min(UTD_MIN_SIN_BETA))
         * (1.0 / math.sqrt(TWO_PI))) * _D_PHASE

    # degenerate shadow/reflection boundary guard
    t1 = floor_mod(sphi, math.pi / 2.0)
    t2 = floor_mod(dphi, math.pi / 2.0)
    degen = (t1.abs() < 1e-5) | (t2.abs() < 1e-5)
    zero = torch.zeros((), dtype=torch.complex64, device=D.device)
    Ds = torch.where(degen, zero, D1 + D2 - (D3 + D4))
    Dh = torch.where(degen, zero, D1 + D2 + (D3 + D4))
    return -D * Ds, -D * Dh
