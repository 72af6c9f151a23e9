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
with ctypes) and adds one to LAUNCHES["cone_minz"] (and, for the build
with winners, to LAUNCHES["cone_minz_winners"] as well); on a CPU tensor it
runs the plain torch version `_minz_ref` (the port of `_launch_ref`: a
loop over triangle tiles of 512, every pair through the full entry math).
Any other device raises. With `winners=True` both also return each
minimum's triangle (the kernel's second build merges (z, id) keys), from
which accel/trace.py takes the minima's derivative (`minz_pairs`).

The kernel reads its own copy of the triangles (`ConeTable`), sorted so
that its 256-triangle tiles are compact, and culls before the pair body:
per warp and tile against the tile's bounding sphere (`tile_spheres`),
then per pair
against the triangle's bounding sphere (`tri_spheres`) and on the local
vertices. `_sphere_cull` (both sphere tests) and `_pair_may_enter` are
the plain twins of those predicates; the tests hold them against
`_minz_block` (a culled pair must be one the body rejects), so the kernel
equals the all-pairs plain version bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from wave_tracer_tpu_torch.accel import nvcc_build, ray_kernels

BIG = 1e30
_EPS = 1e-12
NB = 16                     # schedule boundaries (integrator/traversal.py)
TILE_REF = 512              # triangle tile of the plain version
TILE = 256                  # triangles per bounding-sphere tile (kernel)
# blocks per SM the triangle-range split aims at: blocks finish unevenly
# (their cones cull different tiles), so many short blocks balance better
CHUNK_BLOCKS = 48

# every launch of K3; those of its winner build also under "cone_minz_winners"
LAUNCHES = {"cone_minz": 0, "cone_minz_winners": 0}

_lib = None


def _chunks(N, T, device, block, per_sm):
    """Triangle-range split so that ~`per_sm` blocks of `block` lanes run
    per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ray_blocks = -(-N // block)
    tiles = -(-T // TILE)
    return max(1, min(tiles, -(-per_sm * sms // ray_blocks)))


def cone_tris(p0, e1, e2):
    """(T, 9) f32 rows [A | A+e1 | A+e2], summed in f32 as the JAX sweep
    forms its vertices."""
    return torch.cat([p0, p0 + e1, p0 + e2], dim=1).contiguous()


def bounding_spheres(tri, group):
    """(ceil(T / group), 4) f32 bounding spheres [centre | radius] of the
    groups of `group` consecutive triangles of `tri` (T, 9) in row order.
    Centre and radius are taken in f64; the radius is measured from the
    f32-rounded centre and rounded up."""
    T = tri.shape[0]
    ng = -(-T // group)
    if T == 0:
        return tri.new_zeros((0, 4))
    rows = torch.arange(ng * group, device=tri.device).clamp_max(T - 1)
    v = tri.double()[rows].reshape(ng, group * 3, 3)
    c = ((v.amin(1) + v.amax(1)) * 0.5).float().double()
    r = (v - c[:, None]).norm(dim=-1).amax(1)
    return torch.cat([c, (r * (1 + 1e-6) + 1e-12)[:, None]], 1).float()


def tile_spheres(tri):
    """The bounding spheres of the kernel's 256-triangle tiles."""
    return bounding_spheres(tri, TILE)


def tri_spheres(tri):
    """The bounding sphere of each triangle, (T, 4)."""
    return bounding_spheres(tri, 1)


class ConeTable(NamedTuple):
    """K3's own copy of the triangles, in `ray_kernels.tile_order` (so
    that its 256-triangle tiles are compact): rows (T + pad, 9), zero-
    padded to a multiple of 4 rows (the kernel streams whole 16-byte
    words), the bake-order id of each row (T,) i32, which the exclusion
    compares, and the bounding spheres of its tiles (`tile_spheres`) and
    of each row (`tri_spheres`)."""
    tris: torch.Tensor
    ids: torch.Tensor
    tiles: torch.Tensor
    spheres: torch.Tensor


def cone_table(tri, order):
    """The ConeTable of `tri` (T, 9) in the row order `order`."""
    rows = tri[order]
    return ConeTable(torch.cat([rows, rows.new_zeros((-len(rows) % 4, 9))]),
                     order.to(torch.int32), tile_spheres(rows),
                     tri_spheres(rows))


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
    lib.wt_cone_minz.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, ci,
                                 ctypes.c_float, vp, vp, vp, vp, vp]
    lib.wt_cone_minz.restype = ci
    _lib = lib
    return lib


def _launch(tri, table, ro, rd, xh, e, x0, ta, zmax, exclude, bnd, zmin,
            stats, winners):
    lib = build()
    dev = ro.device
    N, T = ro.shape[0], tri.shape[0]
    rows, ids, tiles, spheres = table
    f32 = torch.float32
    for name, x, dt in (("tri", rows, f32), ("ids", ids, torch.int32),
                        ("tiles", tiles, f32), ("spheres", spheres, f32),
                        ("ro", ro, f32), ("rd", rd, f32),
                        ("xh", xh, f32), ("e", e, f32), ("x0", x0, f32),
                        ("ta", ta, f32), ("zmax", zmax, f32),
                        ("exclude", exclude, torch.int32),
                        ("bnd", bnd, f32)):
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"{name}: need a {dt} tensor on {dev}, got "
                             f"{x.dtype} on {x.device}")
    if (tri.ndim != 2 or tri.shape[1] != 9
            or rows.shape != (T + -T % 4, 9) or ids.shape != (T,)
            or bnd.shape != (N, NB)
            or exclude.shape != (N,)
            or tiles.shape != (-(-T // TILE), 4) or spheres.shape != (T, 4)):
        raise ValueError("cone kernel: bad shapes")
    if stats is not None and (stats.shape != (4,)
                              or stats.dtype != torch.int64
                              or stats.device != dev):
        raise ValueError(f"stats: need an int64 (4,) tensor on {dev}")
    if not zmin > 0.0:
        raise ValueError("cone kernel: zmin must be > 0 (the cross-block "
                         "merge compares float bits as ints)")
    lane = torch.cat([ro, rd, xh, e[:, None], x0[:, None], ta[:, None],
                      zmax[:, None], ro.new_zeros((N, 3))], dim=1)
    bnd, exclude, ids, tiles, spheres = (
        bnd.contiguous(), exclude.contiguous(), ids.contiguous(),
        tiles.contiguous(), spheres.contiguous())
    # tiles stream through cp.async in 16-byte words
    for name, x in (("tri", rows), ("spheres", spheres)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte words, so "
                             "the rows must be contiguous from a 16-byte "
                             "boundary (`cone_table`)")
    zc = torch.full((N, NB), float("inf"), dtype=f32, device=dev)
    cnt = torch.zeros((N,), dtype=torch.int32, device=dev)
    # the winner build's (z bits << 32 | id) keys; ~0 (−1 as int64): none
    keys = torch.full((N, NB), -1, dtype=torch.int64, device=dev) \
        if winners else None
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = lib.wt_cone_minz(rows.data_ptr(), ids.data_ptr(), tiles.data_ptr(),
                           spheres.data_ptr(), T,
                           _chunks(N, T, dev, block=128, per_sm=CHUNK_BLOCKS),
                           lane.data_ptr(),
                           exclude.data_ptr(), bnd.data_ptr(), N,
                           float(zmin), zc.data_ptr(), cnt.data_ptr(),
                           None if stats is None else stats.data_ptr(),
                           None if keys is None else keys.data_ptr(),
                           stream)
    if err != 0:
        raise RuntimeError(f"cone kernel launch failed: cudaError {err}")
    LAUNCHES["cone_minz"] += 1
    if not winners:
        return zc, cnt
    LAUNCHES["cone_minz_winners"] += 1      # the same launch, its winner build
    # z ≥ zmin > 0, so a key's high word is the bits of a finite float
    none = keys == -1
    zc = torch.where(none, float("inf"),
                     (keys >> 32).to(torch.int32).view(f32))
    win = torch.where(none, -1, (keys & 0xFFFFFFFF).to(torch.int32))
    return zc, cnt, win


# ---------------------------------------------------------------------------
# plain torch version (the port of mxu_cone._launch_ref / _minz_block)
# ---------------------------------------------------------------------------

def _sqrt0(x):
    """sqrt(max(x, 0)) rounded as the kernel's IEEE sqrtf rounds it, NaN
    where x is, with a zero derivative where x ≤ 0 (the plain sqrt's is
    ∞ · 0 = NaN there, in both AD modes). torch's float32 sqrt on the CPU
    is one ulp off on some inputs (0.6% of uniform draws on an AVX-512
    build), so the root is taken in float64 and rounded once: a correctly
    rounded float64 root rounds to the correctly rounded float32 one."""
    pos = x > 0
    root = torch.sqrt(torch.where(pos, x, 1.0).double()).to(x.dtype)
    return torch.where(pos, root, torch.where(torch.isnan(x), x, 0.0))


def _safe_div(a, b):
    # a where of two Python floats takes torch's default dtype: pin b's, so
    # that the result never depends on torch.set_default_dtype
    eps = torch.where(b < 0, -_EPS, _EPS).to(b.dtype)
    return a / torch.where(b.abs() < _EPS, eps, b)


def _edge_entry_z(A, B, x0, ta, zlo_eff, zmin, zmax):
    """Minimal-z of segment AB inside the circular cone r = x0 + ta z."""
    Ax, Ay, Az = A
    Ex, Ey, Ez = B[0] - Ax, B[1] - Ay, B[2] - Az
    r0 = x0 + ta * Az
    a = Ex * Ex + Ey * Ey - (ta * Ez) ** 2
    b = 2.0 * (Ax * Ex + Ay * Ey - ta * Ez * r0)
    c = Ax * Ax + Ay * Ay - r0 * r0
    disc = b * b - 4.0 * a * c
    sq = _sqrt0(disc)
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
    rho = _sqrt0(lnx * lnx + lny * lny)

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


def _local_coords(tile, ro, rd, xh, e):
    """Local scaled coordinates of a tile of points (bt, 3·P), P = 3 for
    triangles, for every lane: P (x, y, z) tuples of (N, bt); or of each
    lane's own points (N, bt, 3·P). yh = rd × xh and the dot products
    are written out so that every operation rounds as the kernel's does
    (fused library kernels such as torch.linalg.cross may contract
    multiply-adds on the card)."""
    r0, r1, r2 = (rd[:, c:c + 1] for c in range(3))
    x_0, x_1, x_2 = (xh[:, c:c + 1] for c in range(3))
    axes = ((x_0, x_1, x_2),
            (r1 * x_2 - r2 * x_1, r2 * x_0 - r0 * x_2, r0 * x_1 - r1 * x_0),
            (r0, r1, r2))
    o = [ro[:, c:c + 1] for c in range(3)]
    ecc = e[:, None]
    local = []
    for p in range(tile.shape[-1] // 3):
        u = [tile[..., 3 * p + c] - o[c] for c in range(3)]

        def dot(a):
            return u[0] * a[0] + u[1] * a[1] + u[2] * a[2]
        local.append((dot(axes[0]), ecc * dot(axes[1]), dot(axes[2])))
    return local


def _minz_ref(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd, zmin,
              winners=False):
    """Plain version of K3 → (zc (N, 16) f32 with inf where none,
    cnt (N,) i32), and with `winners` win (N, 16) i32: the triangle of
    each minimum, the least id among equal z, −1 where none. All pairs,
    no cull."""
    N = ro.shape[0]
    lane = [v[:, None] for v in (x0, ta, zmax)]
    mins = torch.full((N, NB), BIG, dtype=torch.float32, device=ro.device)
    cnt = torch.zeros((N,), dtype=torch.int32, device=ro.device)
    win = torch.full((N, NB), -1, dtype=torch.int32, device=ro.device)
    for base in range(0, tri.shape[0], TILE_REF):
        tile = tri[base:base + TILE_REF]
        z = _minz_block(*_local_coords(tile, ro, rd, xh, e), *lane, zmin)
        ids = torch.arange(base, base + tile.shape[0], dtype=torch.int32,
                           device=ro.device)
        ok = (z < BIG) & (ids[None, :] != exclude[:, None])
        cnt += ok.sum(1, dtype=torch.int32)
        z = torch.where(ok, z, BIG)
        for j in range(NB):
            zm = torch.where(z >= bnd[:, j:j + 1], z, BIG)
            zj = zm.amin(1)
            if winners:
                # tiles come in id order: a later tile wins only below
                wj = torch.where(zm == zj[:, None], ids[None, :],
                                 torch.iinfo(torch.int32).max).amin(1)
                win[:, j] = torch.where(zj < mins[:, j], wj, win[:, j])
            mins[:, j] = torch.minimum(mins[:, j], zj)
    zc = torch.where(mins >= BIG, float("inf"), mins)
    return (zc, cnt, win) if winners else (zc, cnt)


def minz_pairs(verts, ro, rd, xh, e, x0, ta, zmax, zmin=1e-7):
    """The exact entry z of each lane's cone into its own triangles:
    verts (N, B, 9) world vertices [A | B | C], lane inputs as
    `cone_minz`'s → (N, B), BIG where none. Plain torch and differentiable
    (the derivative of the winning case); on the kernel's winners it
    gives the kernel's minima."""
    return _minz_block(*_local_coords(verts, ro, rd, xh, e),
                       *(v[:, None] for v in (x0, ta, zmax)), zmin)


# ---------------------------------------------------------------------------
# plain twins of the kernel's two culls (csrc/cone_kernels.cu); the kernel
# skips a pair only where these say it may not enter
# ---------------------------------------------------------------------------

def _cull_pad(R, x0, ta, mag):
    """Margin of both culls for coordinates of magnitude `mag`: 4·R, R the
    radius bound (the conic near point the body accepts may lie √3·R off
    the axis), twice the sqrt of the body's tolerance 1e-6·max(r0², 1),
    and 1e-2·mag for the fp32 rounding of the squared distances the body
    compares (the derivation: csrc/cone_kernels.cu's header)."""
    return 4.0 * R + 2e-3 * (x0.abs() + ta.abs() * mag) + 1e-2 * mag


def _lane_cull_terms(x0, ta, zmax, zmin):
    """(zlo_eff, R, rinv): the least z an entry off the axis may have, the
    largest |cone radius| over [zlo_eff, zmax], and 1 / (1 − 1.8·ta)."""
    apex = -_safe_div(x0, ta.clamp_min(_EPS))
    zlo_eff = torch.where(ta > 0, apex, -BIG).clamp_min(zmin)
    return (zlo_eff, torch.fmax((x0 + ta * zlo_eff).abs(),
                                (x0 + ta * zmax).abs()),
            1.0 / (1.0 - 1.8 * ta))


def _radius_bound(R, x0, ta, rinv, zlo_eff, zh):
    """The cone radius an entry into a triangle (or tile) whose highest
    local z is zh may see: vertices and edge points lie at z ≤ zh, the
    conic near point at z_c ≤ zh + √3·r(z_c), so r ≤ (x0 + ta·zh) /
    (1 − 1.8·ta) for x0 ≥ 0 and 0 ≤ ta < 0.5; never above R."""
    tight = torch.fmin(R, (x0 + ta * torch.fmax(zh, zlo_eff)) * rinv)
    return torch.where((x0 >= 0) & (ta >= 0) & (ta < 0.5), tight, R)


def _sphere_cull(spheres, ro, rd, xh, e, x0, ta, zmax, zmin):
    """Twin of sphere_may_enter → (N, S) bool: may the lane's cone reach
    the bounding sphere (a tile's or a triangle's)? The margin comes from
    the sphere's largest local coordinate, inflated by 1e-5, and its
    highest z, so it is at least that of every triangle inside. Lane
    inputs as `cone_minz`'s."""
    (cx, cy, cz), = _local_coords(spheres[:, :3], ro, rd, xh, e)
    x0, ta, zmax = (v[:, None] for v in (x0, ta, zmax))
    zlo_eff, R, rinv = _lane_cull_terms(x0, ta, zmax, zmin)
    rad = spheres[None, :, 3] * e.abs().clamp_min(1.0)[:, None]
    mag = ((torch.fmax(torch.fmax(cx.abs(), cy.abs()), cz.abs()) + rad)
           * 1.00001).clamp_min(1.0)
    pad = _cull_pad(_radius_bound(R, x0, ta, rinv, zlo_eff, cz + rad), x0,
                    ta, mag)
    return ~((cz - rad > zmax + pad) | (cz + rad < zmin - pad)
             | (cx.abs() - rad > pad) | (cy.abs() - rad > pad))


def _pair_may_enter(A, B, C, x0, ta, zmax, zmin):
    """Twin of pair_may_enter: False where the triangle's local vertices
    lie wholly above zmax, below zmin, or beyond the cone in x or in y,
    by more than the pair's margin. A, B, C: (x, y, z) tuples of
    (N, bt) local coordinates; lane scalars (N, 1). NaN coordinates never
    cull (fmax/fmin drop NaN)."""
    zlo_eff, R, rinv = _lane_cull_terms(x0, ta, zmax, zmin)
    mag = torch.ones_like(A[0])
    for c in (*A, *B, *C):
        mag = torch.fmax(mag, c.abs())

    def lo(k):
        return torch.fmin(torch.fmin(A[k], B[k]), C[k])

    def hi(k):
        return torch.fmax(torch.fmax(A[k], B[k]), C[k])
    pad = _cull_pad(_radius_bound(R, x0, ta, rinv, zlo_eff, hi(2)), x0, ta,
                    mag)
    return ~((lo(2) > zmax + pad) | (hi(2) < zmin - pad)
             | (lo(0) > pad) | (hi(0) < -pad)
             | (lo(1) > pad) | (hi(1) < -pad))


def cone_minz(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd, zmin=1e-7,
              *, table, stats=None, winners=False):
    """K3: per-boundary earliest exact cone–triangle entries.

    tri (T, 9) f32 world vertices (`cone_tris`), which the plain version
    reads, and the kernel's copy of them, `table` (`cone_table`); per
    lane: ro, rd, xh (N, 3) origin, unit
    axis and unit major-axis direction, e, x0, ta, zmax (N,), exclude (N,)
    i32 (−1 = none), bnd (N, 16) boundaries (pad with BIG). `stats`, for
    measurement only: an int64 (4,) tensor on the card to which a counting
    build of the kernel adds the pairs tested after the tile cull, the
    pairs that entered the pair body, the warp-iterations and those in
    which some lane entered the body. Returns (zc (N, 16) f32, inf where
    no encounter ≥ bnd_j; cnt (N,) i32 encounters) and, with `winners`,
    win (N, 16) i32, the bake-order id of each minimum's triangle (the
    least id among equal z), −1 where none: a second build of the kernel
    merges (z, id) keys. Every input must be primal
    (`ray_kernels.check_primal`): the minima carry no derivative
    (accel/trace.py recomputes the winners' z to take one)."""
    ray_kernels.check_primal("cone kernel", tri, ro, rd, xh, e, x0, ta,
                             zmax, exclude, bnd)
    with ray_kernels.outside_transforms():
        if ro.device.type == "cpu":
            return _minz_ref(tri, ro, rd, xh, e, x0, ta, zmax, exclude, bnd,
                             zmin, winners)
        if ro.device.type != "cuda":
            raise NotImplementedError(
                f"cone kernel: no backend for {ro.device}")
        return _launch(tri, table, ro, rd, xh, e, x0, ta, zmax, exclude,
                       bnd, zmin, stats, winners)
