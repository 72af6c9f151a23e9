"""2D Gaussian mass over triangles, and the z-slab triangle clipper.

Port of wave_tracer_tpu/math/gaussian2d.py. The mass of a centred
axis-aligned Gaussian over a triangle is taken with Green's theorem in
the Gaussian's canonical frame: per edge the parameter range is clipped
to the band |y| ≤ L, the saturated piece x > L integrates analytically
to Φ(y) differences, and only the window x ∈ [−L, L] takes a 16-point
Gauss–Legendre quadrature. `clip_triangle_z` clips beam-local triangles
to a z slab (Sutherland–Hodgman, fixed capacity). Used by the bdpt
blocked-flux integral.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT_HALF = math.sqrt(0.5)
L_BAND = 5.0          # canonical saturation bound (erf(5/√2) ≈ 1 − 6e-13)
_GL_N = 16
CAP = 5               # max polygon vertices after a two-plane slab clip

# Gauss–Legendre nodes/weights on [0, 1], rounded to f32 as the JAX
# module's device constants are
_gl_x, _gl_w = np.polynomial.legendre.leggauss(_GL_N)
GL_T = (0.5 * (_gl_x + 1.0)).astype(np.float32)
GL_W = (0.5 * _gl_w).astype(np.float32)


def _phi(y):
    """Standard normal density."""
    return torch.exp(-0.5 * y * y) / math.sqrt(2.0 * math.pi)


def _Phi(x):
    """Standard normal CDF."""
    return 0.5 * (1.0 + torch.special.erf(x * SQRT_HALF))


def _edge_mass(p0, p1):
    """Signed Green's-theorem contribution of one canonical-space edge.
    p0, p1: (..., 2). Returns (...,)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    dx = x1 - x0
    dy = y1 - y0
    zero = torch.zeros_like(dx)
    one = torch.ones_like(dx)

    # clip t to the band |y| ≤ L (y linear in t)
    y_const = dy.abs() < 1e-12
    safe_dy = torch.where(y_const, 1e-12, dy)
    ta = (-L_BAND - y0) / safe_dy
    tb = (L_BAND - y0) / safe_dy
    t_lo = torch.minimum(ta, tb).clamp(0.0, 1.0)
    t_hi = torch.maximum(ta, tb).clamp(0.0, 1.0)
    y_in = y0.abs() <= L_BAND
    t_lo = torch.where(y_const, torch.where(y_in, zero, one), t_lo)
    t_hi = torch.where(y_const, one, t_hi)

    # x saturation split: s_lo/s_hi bound the window x(t) ∈ [−L, L]
    x_const = dx.abs() < 1e-12
    safe_dx = torch.where(x_const, 1e-12, dx)
    sa = (-L_BAND - x0) / safe_dx
    sb = (L_BAND - x0) / safe_dx
    s_lo = torch.minimum(sa, sb)
    s_hi = torch.maximum(sa, sb)

    # quadrature window [q0, q1] = [t_lo, t_hi] ∩ [s_lo, s_hi]
    q0 = torch.maximum(t_lo, s_lo).clamp(0.0, 1.0)
    q1 = torch.minimum(t_hi, s_hi).clamp(0.0, 1.0)
    x_in = x0.abs() <= L_BAND
    q0 = torch.where(x_const, torch.where(x_in, t_lo, t_hi), q0)
    q1 = torch.where(x_const, t_hi, q1)
    q1 = torch.maximum(q1, q0)

    def Phi_y(t):
        return _Phi(y0 + dy * t)

    # saturated pieces (Φ(x) = 1 where x(t) > L): before the window when
    # x decreases, after it when x increases: Φ(y(t1)) − Φ(y(t0))
    a0 = t_lo
    a1 = torch.maximum(torch.minimum(t_hi, s_lo.clamp(0.0, 1.0)), a0)
    b1 = t_hi
    b0 = torch.minimum(torch.maximum(t_lo, s_hi.clamp(0.0, 1.0)), b1)
    contrib = torch.where(~x_const & (dx < 0), Phi_y(a1) - Phi_y(a0), zero) \
        + torch.where(~x_const & (dx > 0), Phi_y(b1) - Phi_y(b0), zero) \
        + torch.where(x_const & (x0 > L_BAND), Phi_y(t_hi) - Phi_y(t_lo),
                      zero)

    # quadrature over the transition window
    gl_t = torch.as_tensor(GL_T, device=dx.device)
    gl_w = torch.as_tensor(GL_W, device=dx.device)
    t = q0[..., None] + (q1 - q0)[..., None] * gl_t
    xq = x0[..., None] + dx[..., None] * t
    yq = y0[..., None] + dy[..., None] * t
    integ = (gl_w * _Phi(xq) * _phi(yq)).sum(-1)
    return contrib + integ * (q1 - q0) * dy


def integrate_triangle(a, b, c, sx, sy):
    """Mass of the centred axis-aligned Gaussian N(0, diag(sx², sy²))
    over triangle (a, b, c) — points (..., 2) in the Gaussian's frame.
    Returns (...,) in [0, 1], winding-independent."""
    sx = sx.clamp_min(1e-30)
    sy = sy.clamp_min(1e-30)
    s = torch.stack([sx.expand(a.shape[:-1]), sy.expand(a.shape[:-1])],
                    dim=-1)
    ac, bc, cc = a / s, b / s, c / s
    # the three edges as one batch
    em = _edge_mass(torch.stack([ac, bc, cc]), torch.stack([bc, cc, ac]))
    m = em[0] + em[1] + em[2]
    return m.abs().clamp(0.0, 1.0)


def _emit(out, cnt, v, do):
    """Write v into slot cnt of out where do (a per-row masked select)."""
    idx = torch.arange(CAP, device=out.device)
    sel = (idx == cnt[..., None]) & do[..., None]
    return torch.where(sel[..., None], v[..., None, :], out)


def _take_slot(verts, j):
    """verts (..., CAP, 3) at per-row slot j (...,)."""
    return torch.gather(verts, -2, j[..., None, None].long().expand(
        j.shape + (1, 3)))[..., 0, :]


def clip_triangle_z(pa, pb, pc, z0, z1):
    """Clip triangle (pa, pb, pc) — (..., 3) beam-local points — against
    the slab z ∈ [z0, z1] (z0/z1 (...,)). Returns (verts (..., CAP, 3),
    nverts (...,) i32): the clipped convex polygon, padded with its last
    valid vertex so fan triangles past nverts are degenerate."""
    def clip_half(verts, nv, plane_z, keep_below):
        out = verts.new_zeros(verts.shape[:-2] + (CAP, 3))
        cnt = torch.zeros_like(nv)
        for i in range(CAP):
            vi = verts[..., i, :]
            j = torch.where(i + 1 < nv, i + 1, 0)
            vj = _take_slot(verts, j)
            if keep_below:
                in_i = vi[..., 2] <= plane_z
                in_j = vj[..., 2] <= plane_z
            else:
                in_i = vi[..., 2] >= plane_z
                in_j = vj[..., 2] >= plane_z
            live = i < nv
            dz = vj[..., 2] - vi[..., 2]
            t = (plane_z - vi[..., 2]) / torch.where(dz.abs() < 1e-30,
                                                     1e-30, dz)
            xp = vi + t.clamp(0.0, 1.0)[..., None] * (vj - vi)
            emit1 = live & in_i
            out = _emit(out, cnt, vi, emit1)
            cnt = cnt + emit1.to(cnt.dtype)
            emit2 = live & (in_i != in_j)
            out = _emit(out, cnt, xp, emit2)
            cnt = cnt + emit2.to(cnt.dtype)
        return out, cnt

    verts0 = torch.stack([pa, pb, pc] + [pc] * (CAP - 3), dim=-2)
    nv0 = torch.full(pa.shape[:-1], 3, dtype=torch.int32, device=pa.device)
    v1, n1 = clip_half(verts0, nv0, z1, True)     # keep z <= z1
    v2, n2 = clip_half(v1, n1, z0, False)         # keep z >= z0
    last = _take_slot(v2, (n2 - 1).clamp_min(0))
    idx = torch.arange(CAP, device=pa.device)
    mask = (idx < n2[..., None])[..., None]
    return torch.where(mask, v2, last[..., None, :]), n2


def polygon_gaussian_mass(verts, nverts, sx, sy):
    """Gaussian mass over the convex polygon (verts (..., CAP, ≥2),
    nverts (...,)) via the fan (v0, vi, vi+1), on the x/y components.
    The CAP − 2 fan triangles go through `integrate_triangle` as one
    batch (each value as its own call would give it)."""
    v2 = verts[..., :2]
    F = CAP - 2
    a = v2[..., 0:1, :].expand(v2.shape[:-2] + (F, 2))
    m = integrate_triangle(a, v2[..., 1:CAP - 1, :], v2[..., 2:CAP, :],
                           sx[..., None].expand(sx.shape + (F,)),
                           sy[..., None].expand(sy.shape + (F,)))
    fan = torch.arange(1, CAP - 1, device=verts.device)
    m = torch.where(fan + 1 < nverts[..., None], m, 0.0)
    total = torch.zeros(nverts.shape, dtype=torch.float32,
                        device=verts.device)
    for i in range(F):
        total = total + m[..., i]
    return total.clamp(0.0, 1.0)
