"""Dense exact cone–triangle boundary sweep: CUDA kernel K3 and its plain
torch version.

Port of wave_tracer_tpu/accel/mxu_cone.py. For every (lane, triangle)
pair the exact minimal entry z of the lane's elliptic cone into the
triangle is computed (`_minz_block`: vertex containment, the three edge
quadratics, the central-axis hit and the conic near point inside the
triangle), with one excluded triangle id per lane. Per lane only the 16
masked minima min{z : z ≥ bnd_j} over all triangles and the number of
triangles met are kept.

Local coordinates are taken subtract-first: u = V − ro, then
(xh·u, e·(yh·u), rd·u) with yh = rd × xh, as accel/trace.py of the JAX
package does. (The MXU kernel's bilinear [v, 1] contraction cancels badly
for small triangles far from the origin.)

On a CUDA tensor `cone_minz` launches the hand-written kernel
(csrc/cone_kernels.cu, built with nvcc for sm_90a at first use and loaded
with ctypes) and adds one to LAUNCHES["cone_minz"]; on a CPU tensor it
runs the plain torch version `_minz_ref` (the port of `_launch_ref`: a
loop over triangle tiles of 512). Any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from wave_tracer_tpu_torch.accel import nvcc_build
from wave_tracer_tpu_torch.accel.ray_kernels import _chunks

BIG = 1e30
_EPS = 1e-12
NB = 16                     # schedule boundaries (integrator/traversal.py)
TILE_REF = 512              # triangle tile of the plain version

LAUNCHES = {"cone_minz": 0}

_lib = None


def cone_tris(p0, e1, e2):
    """(T, 9) f32 rows [A | A+e1 | A+e2], summed in f32 as the JAX sweep
    forms its vertices."""
    return torch.cat([p0, p0 + e1, p0 + e2], dim=1).contiguous()


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def build():
    """Compile csrc/cone_kernels.cu (if its hash changed) and bind it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc_build.build("cone_kernels")["cone_kernels"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wt_cone_minz.argtypes = [vp, ci, ci, vp, vp, vp, ci,
                                 ctypes.c_float, vp, vp, vp]
    lib.wt_cone_minz.restype = ci
    _lib = lib
    return lib


def _launch(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd, zmin):
    lib = build()
    dev = ro.device
    N, T = ro.shape[0], tri.shape[0]
    f32 = torch.float32
    for name, x, dt in (("tri", tri, f32), ("ro", ro, f32), ("rd", rd, f32),
                        ("xh", xh, f32), ("e", e, f32), ("x0", x0, f32),
                        ("ta", ta, f32), ("zmax", zmax, f32),
                        ("exclude", exclude, torch.int32),
                        ("bnd", bnd, f32)):
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"{name}: need a {dt} tensor on {dev}, got "
                             f"{x.dtype} on {x.device}")
    if (tri.ndim != 2 or tri.shape[1] != 9 or bnd.shape != (N, NB)
            or exclude.shape != (N,)):
        raise ValueError("cone kernel: bad shapes")
    if not zmin > 0.0:
        raise ValueError("cone kernel: zmin must be > 0 (the cross-block "
                         "merge compares float bits as ints)")
    lane = torch.cat([ro, rd, xh, e[:, None], x0[:, None], ta[:, None],
                      zmax[:, None], ro.new_zeros((N, 3))], dim=1)
    tri, bnd, exclude = (tri.contiguous(), bnd.contiguous(),
                         exclude.contiguous())
    zc = torch.full((N, NB), float("inf"), dtype=f32, device=dev)
    cnt = torch.zeros((N,), dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = lib.wt_cone_minz(tri.data_ptr(), T, _chunks(N, T, dev),
                           lane.data_ptr(), exclude.data_ptr(),
                           bnd.data_ptr(), N, float(zmin), zc.data_ptr(),
                           cnt.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cone kernel launch failed: cudaError {err}")
    LAUNCHES["cone_minz"] += 1
    return zc, cnt


# ---------------------------------------------------------------------------
# plain torch version (the port of mxu_cone._launch_ref / _minz_block)
# ---------------------------------------------------------------------------

def _safe_div(a, b):
    return a / torch.where(b.abs() < _EPS, torch.where(b < 0, -_EPS, _EPS),
                           b)


def _edge_entry_z(A, B, x0, ta, zlo_eff, zmin, zmax):
    """Minimal-z of segment AB inside the circular cone r = x0 + ta z."""
    Ax, Ay, Az = A
    Ex, Ey, Ez = B[0] - Ax, B[1] - Ay, B[2] - Az
    r0 = x0 + ta * Az
    a = Ex * Ex + Ey * Ey - (ta * Ez) ** 2
    b = 2.0 * (Ax * Ex + Ay * Ey - ta * Ez * r0)
    c = Ax * Ax + Ay * Ay - r0 * r0
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    qq = -0.5 * (b + torch.sign(b) * sq)
    lin = a.abs() < _EPS
    s_lin = _safe_div(-c, b)
    s_r1 = torch.where(lin, s_lin, _safe_div(qq, a))
    s_r2 = torch.where(lin, s_lin, _safe_div(c, qq))
    roots_ok = (lin & (b.abs() >= _EPS)) | (~lin & (disc >= 0.0))
    s_zlo = _safe_div(zmin - Az, Ez)
    s_zhi = _safe_div(zmax - Az, Ez)
    best = torch.full_like(Ax, BIG)
    tol = 1e-6 * (r0 * r0).clamp_min(1.0)
    for s_c, extra in ((s_r1, roots_ok), (s_r2, roots_ok),
                       (torch.zeros_like(s_r1), None),
                       (torch.ones_like(s_r1), None),
                       (s_zlo, None), (s_zhi, None)):
        s = s_c.clamp(0.0, 1.0)
        q = (a * s + b) * s + c
        z = Az + s * Ez
        ok = (q <= tol) & (z >= zlo_eff) & (z <= zmax)
        if extra is not None:
            ok = ok & extra
        best = torch.where(ok & (z < best), z, best)
    return best


def _point_in_tri_2d(px, py, ax, ay, bx, by, cx, cy):
    def edge(ux, uy, vx, vy):
        return (vx - ux) * (py - uy) - (vy - uy) * (px - ux)
    e0 = edge(ax, ay, bx, by)
    e1 = edge(bx, by, cx, cy)
    e2 = edge(cx, cy, ax, ay)
    return ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) \
        | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))


def _minz_block(A, B, C, x0, ta, zmax, zmin):
    """Exact minimal entry z per (lane, tri) pair, BIG where none. A, B, C:
    (x, y, z) tuples of (N, bt) local scaled coordinates; lane scalars
    (N, 1)."""
    Ax, Ay, Az = A
    Bx, By, Bz = B
    Cx, Cy, Cz = C
    apex = -_safe_div(x0, ta.clamp_min(_EPS))
    zlo_eff = torch.where(ta > 0, apex, -BIG).clamp_min(zmin)
    best = torch.full_like(Ax, BIG)

    # 1. vertices inside the cone
    for (Vx, Vy, Vz) in (A, B, C):
        r = x0 + ta * Vz
        ok = (Vz >= zlo_eff) & (Vz <= zmax) & (Vx * Vx + Vy * Vy <= r * r)
        best = torch.where(ok & (Vz < best), Vz, best)

    # 2. edge entries
    for (P, Q) in ((A, B), (A, C), (B, C)):
        best = torch.minimum(best, _edge_entry_z(P, Q, x0, ta, zlo_eff,
                                                 zmin, zmax))

    # 3. central-axis hit, the normal recomputed from the local edges
    e1x, e1y, e1z = Bx - Ax, By - Ay, Bz - Az
    e2x, e2y, e2z = Cx - Ax, Cy - Ay, Cz - Az
    lnx = e1y * e2z - e1z * e2y
    lny = e1z * e2x - e1x * e2z
    lnz = e1x * e2y - e1y * e2x
    d = lnx * Ax + lny * Ay + lnz * Az
    z_ax = _safe_div(d, lnz)
    zero = torch.zeros_like(Ax)
    in_ax = _point_in_tri_2d(zero, zero, Ax, Ay, Bx, By, Cx, Cy)
    ok_ax = in_ax & (lnz.abs() > _EPS) & (z_ax >= zmin) \
        & (z_ax <= zmax) & (z_ax >= zlo_eff)
    best = torch.where(ok_ax & (z_ax < best), z_ax, best)

    # 4. conic near point inside the triangle
    rho = torch.sqrt(lnx * lnx + lny * lny)

    def bound(a, b):
        lo = torch.where(a > _EPS, b / a.clamp_min(_EPS), -BIG)
        hi = torch.where(a < -_EPS, b / a.clamp_max(-_EPS), BIG)
        infeasible = (a.abs() <= _EPS) & (b > 0)
        return torch.where(infeasible, BIG, lo), \
            torch.where(infeasible, -BIG, hi)

    lo1, hi1 = bound(rho * ta + lnz, d - rho * x0)
    lo2, hi2 = bound(rho * ta - lnz, -d - rho * x0)
    z_lo = torch.maximum(torch.maximum(lo1, lo2), zlo_eff)
    z_hi = torch.minimum(torch.minimum(hi1, hi2), zmax)
    ok_c = z_lo <= z_hi
    z_c = z_lo
    r = x0 + ta * z_c
    sgn = torch.sign(d - lnz * z_c)
    sgn = torch.where(sgn == 0, 1.0, sgn)
    safe_rho = rho.clamp_min(_EPS)
    px = sgn * r / safe_rho * lnx
    py = sgn * r / safe_rho * lny
    perp = rho <= _EPS
    z_perp = _safe_div(d, lnz)
    z_c = torch.where(perp, z_perp, z_c)
    px = torch.where(perp, 0.0, px)
    py = torch.where(perp, 0.0, py)
    ok_c = (perp & (z_perp >= zmin) & (z_perp <= zmax)) | (~perp & ok_c)
    anx, any_, anz = lnx.abs(), lny.abs(), lnz.abs()
    use_x = (anx >= any_) & (anx >= anz)     # drop x
    keep_z = use_x | (any_ >= anz)           # drop x or y

    def proj(vx, vy, vz):
        return torch.where(use_x, vy, vx), torch.where(keep_z, vz, vy)

    pu, pv = proj(px, py, z_c)
    au, av = proj(Ax, Ay, Az)
    bu, bv = proj(Bx, By, Bz)
    cu, cv = proj(Cx, Cy, Cz)
    in_c = _point_in_tri_2d(pu, pv, au, av, bu, bv, cu, cv)
    return torch.minimum(best, torch.where(ok_c & in_c, z_c, BIG))


def _minz_ref(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd, zmin):
    """Plain version of K3 → (zc (N, 16) f32 with inf where none,
    cnt (N,) i32)."""
    N = ro.shape[0]
    # yh = rd × xh and the dot products are written out so that every
    # operation rounds as the kernel's does (fused library kernels such as
    # torch.linalg.cross may contract multiply-adds on the card)
    r0, r1, r2 = (rd[:, c:c + 1] for c in range(3))
    x_0, x_1, x_2 = (xh[:, c:c + 1] for c in range(3))
    axes = ((x_0, x_1, x_2),
            (r1 * x_2 - r2 * x_1, r2 * x_0 - r0 * x_2, r0 * x_1 - r1 * x_0),
            (r0, r1, r2))
    o = [ro[:, c:c + 1] for c in range(3)]
    ecc = e[:, None]
    lane = [v[:, None] for v in (x0, ta, zmax)]
    mins = torch.full((N, NB), BIG, dtype=torch.float32, device=ro.device)
    cnt = torch.zeros((N,), dtype=torch.int32, device=ro.device)
    for base in range(0, tri.shape[0], TILE_REF):
        tile = tri[base:base + TILE_REF]
        local = []
        for p in range(3):
            u = [tile[None, :, 3 * p + c] - o[c] for c in range(3)]

            def dot(a):
                return u[0] * a[0] + u[1] * a[1] + u[2] * a[2]
            local.append((dot(axes[0]), ecc * dot(axes[1]), dot(axes[2])))
        z = _minz_block(*local, *lane, zmin)
        ids = torch.arange(base, base + tile.shape[0], dtype=torch.int32,
                           device=ro.device)
        ok = (z < BIG) & (ids[None, :] != exclude[:, None])
        cnt += ok.sum(1, dtype=torch.int32)
        z = torch.where(ok, z, BIG)
        for j in range(NB):
            zj = torch.where(z >= bnd[:, j:j + 1], z, BIG).amin(1)
            mins[:, j] = torch.minimum(mins[:, j], zj)
    return torch.where(mins >= BIG, float("inf"), mins), cnt


def cone_minz(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd, zmin=1e-7):
    """K3: per-boundary earliest exact cone–triangle entries.

    tri (T, 9) f32 world vertices (`cone_tris`); per lane: ro, rd, xh
    (N, 3) origin, unit axis and unit major-axis direction, e, x0, ta,
    zmax (N,), exclude (N,) i32 (−1 = none), bnd (N, 16) boundaries
    (pad with BIG). Returns (zc (N, 16) f32, inf where no encounter
    ≥ bnd_j; cnt (N,) i32 encounters)."""
    if ro.device.type == "cpu":
        return _minz_ref(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd,
                         zmin)
    if ro.device.type != "cuda":
        raise NotImplementedError(f"cone kernel: no backend for {ro.device}")
    return _launch(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd, zmin)
