"""The culls of the redesigned K3 and K2 kernels, through their plain twins
(CPU): a cull may only skip pairs that the full pair test rejects, so that
the kernels stay equal to their all-pairs plain versions.

* K3 (csrc/cone_kernels.cu): `_sphere_cull` (per lane against the
  bounding sphere of each 256-triangle tile and of each triangle) and
  `_pair_may_enter` (per pair, on the local vertices) must hold for every
  pair to which
  `_minz_block` gives a finite entry z — over seeded random cones, over
  render-like narrow cones (`envelope.initial` for camera beams,
  `sourcing.restart_envelope` at visible wavelengths) on the box scene
  with an icosphere inside it, and over cases at the edge: triangles
  straddling zmax, vertices at the apex, ta = 0, degenerate triangles and
  triangles grazing the cone's surface, in rotated frames.
* K2 (csrc/ray_kernels.cu): `_tile_box_may_hit` must hold for every
  (ray, tile) in which `_anyhit_ref`'s pair test finds a hit.
Each case also checks that the cull rejects something, where it should,
so that the test cannot pass on a cull that never fires."""

import math

import numpy as np
import pytest
import torch

from test_torch_threads import cap_torch_threads
from wave_tracer_tpu_torch.accel import cone_kernels as ck
from wave_tracer_tpu_torch.accel import ray_kernels as rk
from wave_tracer_tpu_torch.geometry import mesh
from wave_tracer_tpu_torch.scene import build_scene
from wave_tracer_tpu_torch.scene.model import Shape
from wave_tracer_tpu_torch.scene.procedural import make_box_scene
from wave_tracer_tpu_torch.wave import envelope as env_mod
from wave_tracer_tpu_torch.wave import sourcing

cap_torch_threads()

ZMIN = 1e-7


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _perp(r, rd):
    x = np.cross(rd, _unit(r, len(rd)))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _cone_cull(tri, ro, rd, xh, e, x0, ta, zmax):
    """Asserts that no cull rejects a pair the body accepts. Returns
    (accepted pairs, share of pairs culled by the tile test, share culled
    by the triangle's sphere, share culled by any test)."""
    T, N = tri.shape[0], ro.shape[0]
    tiles = ck.tile_spheres(tri)
    lane_args = (ro, rd, xh, e, x0, ta, zmax, ZMIN)
    tile_ok = ck._sphere_cull(tiles, *lane_args)
    sph_ok = ck._sphere_cull(ck.tri_spheres(tri), *lane_args)
    assert tile_ok.shape == (N, tiles.shape[0]) and sph_ok.shape == (N, T)
    lane = [v[:, None] for v in (x0, ta, zmax)]
    accepted = tile_cut = sph_cut = any_cut = 0
    for base in range(0, T, ck.TILE):
        loc = ck._local_coords(tri[base:base + ck.TILE], ro, rd, xh, e)
        acc = ck._minz_block(*loc, *lane, ZMIN) < ck.BIG
        pair_ok = ck._pair_may_enter(*loc, *lane, ZMIN)
        t_ok = tile_ok[:, base // ck.TILE, None].expand_as(acc)
        s_ok = sph_ok[:, base:base + ck.TILE]
        assert not (acc & ~pair_ok).any(), "pair cull drops an entry"
        assert not (acc & ~s_ok).any(), "triangle sphere drops an entry"
        assert not (acc & ~t_ok).any(), "tile cull drops an entry"
        accepted += int(acc.sum())
        tile_cut += int((~t_ok).sum())
        sph_cut += int((~s_ok).sum())
        any_cut += int((~(t_ok & s_ok & pair_ok)).sum())
    return (accepted, tile_cut / (N * T), sph_cut / (N * T),
            any_cut / (N * T))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cone_cull_random_cones(seed):
    """Seeded random cones (the ranges of tests/test_mxu_cone.py and
    chip_smoke.py, eccentricities below and above 1) in a random soup."""
    r = np.random.default_rng(seed)
    T, N = 600, 256
    p0 = r.uniform(-4, 4, (T, 3))
    tri = np.concatenate([p0, p0 + r.uniform(-1, 1, (T, 3)),
                          p0 + r.uniform(-1, 1, (T, 3))], 1)
    ro = r.uniform(-5, 5, (N, 3)).astype(np.float32)
    rd = _unit(r, N)
    args = [_t(tri), _t(ro), _t(rd), _t(_perp(r, rd))] + [
        _t(r.uniform(lo, hi, N)) for lo, hi in
        ((0.6, 3.0), (0.0, 0.3), (0.0, 0.2), (1.0, 30.0))]
    accepted, _, sph_cut, cut = _cone_cull(*args)
    assert accepted > 100 and cut > 0.3 and sph_cut > 0.2


def _render_scene_tris():
    """The box scene with a 1,280-triangle icosphere inside it (so that
    cones from the walls meet it), as f32 cone rows, with the bake's
    sampler of surface points."""
    scene = make_box_scene(res=8, spp=1)
    scene.shapes.append(Shape(mesh.sphere([0.3, 0.5, -0.2], 0.3,
                                          tessellation=48),
                              scene.shapes[0].material))
    geo = build_scene(scene, device="cpu").data.geo
    return geo, scene.world_radius()


@pytest.mark.parametrize("kind", ["camera", "restart"])
def test_cone_cull_render_like_narrow_cones(kind):
    """Narrow beams as the render makes them: camera beams from the eye
    (x0 = 0, ta = half a pixel's tan at 256 px, fov 60°) and FSD restart
    beams from points on the surfaces (x0 = 1e-6, the minimum-uncertainty
    ta of a 1e-4..1e-2 footprint at 380-720 nm), zmax as the bounce sets
    it (a hit distance · 1.02 + x0, or 8 scene radii)."""
    geo, radius = _render_scene_tris()
    r = np.random.default_rng(11)
    N = 384
    T = geo.num_tris
    if kind == "camera":
        ro = np.tile(np.float32([0.0, 1.0, 3.2]), (N, 1))
        rd = _unit(r, N)
        rd[:, 2] = -np.abs(rd[:, 2]) - 1.0
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        env = env_mod.initial(_t(rd), 0.0,
                              0.5 * math.tan(math.radians(30.0)) / 128)
    else:
        tri = np.asarray(geo.tri_geom[:, :9])
        pick = r.integers(0, T, N)
        u = r.random((N, 2))
        u = np.where(u.sum(1, keepdims=True) > 1, 1 - u, u)
        ro = (tri[pick, 0:3] + u[:, :1] * tri[pick, 3:6]
              + u[:, 1:] * tri[pick, 6:9]).astype(np.float32)
        rd = _unit(r, N)
        k = _t(2 * np.pi / r.uniform(380e-9, 720e-9, N))
        env = sourcing.restart_envelope(_t(rd), _t(10 ** r.uniform(-4, -2, N)),
                                        k)
    zmax = np.where(r.random(N) < 0.5, r.uniform(0.05, 4.0, N) * 1.02,
                    8.0 * radius).astype(np.float32)
    # the kernel's copy of the triangles, in its tile order
    accepted, tile_cut, sph_cut, cut = _cone_cull(
        geo.cone_table.tris[:T], _t(ro), _t(rd), env.x, env.e, env.x0,
        env.ta, _t(zmax) + env.x0)
    assert accepted > 0
    assert cut > 0.9 and sph_cut > 0.9 and tile_cut > 0.5


def _frame(r, n):
    """n random orthonormal frames (rd, xh) and origins."""
    rd = _unit(r, n)
    return r.uniform(-3, 3, (n, 3)).astype(np.float32), rd, _perp(r, rd)


def _to_world(loc, ro, rd, xh, e):
    """Local scaled coordinates (…, 3) of one lane → world points."""
    yh = np.cross(rd, xh)
    return (ro + loc[..., :1] * xh + (loc[..., 1:2] / e) * yh
            + loc[..., 2:] * rd)


@pytest.mark.parametrize("seed", [0, 1])
def test_cone_cull_edge_cases(seed):
    """Triangles built in each lane's local frame at the edges of the
    entry test: straddling zmax and zlo_eff by 0..1e-2, with a vertex at
    the apex, grazing the cone's surface by 0..2e-3 (the body's tolerance
    admits points ~1e-3 off), degenerate (coincident and collinear
    vertices), for cones with ta = 0 and x0 = 0 among them, in rotated
    frames. Each lane meets its own triangles and the others'."""
    r = np.random.default_rng(100 + seed)
    N = 64
    ro, rd, xh = _frame(r, N)
    e = r.choice([1.0, 0.7, 2.5], N).astype(np.float32)
    x0 = r.choice([0.0, 1e-6, 0.01, 0.2], N).astype(np.float32)
    ta = r.choice([0.0, 1e-4, 0.01, 0.15], N).astype(np.float32)
    zmax = r.uniform(0.5, 6.0, N).astype(np.float32)
    tris = []
    for i in range(N):
        rad = lambda z: x0[i] + ta[i] * z              # noqa: E731
        zl = max(ZMIN, -x0[i] / ta[i] if ta[i] > 0 else ZMIN)
        for _ in range(6):
            phi = r.uniform(0, 2 * np.pi, 3)
            kind = r.integers(0, 5)
            if kind == 0:      # straddle or just miss zmax
                z = zmax[i] + r.choice([-1e-2, -1e-6, 0.0, 1e-7, 1e-5,
                                        1e-2], 3)
            elif kind == 1:    # around zlo_eff / the apex
                z = zl + r.choice([-1e-3, -1e-7, 0.0, 1e-7, 1e-3], 3)
            else:
                z = r.uniform(zl, zmax[i], 3)
            rho = np.array([rad(zz) for zz in z]) \
                + r.choice([-2e-3, -1e-3, -1e-6, 0.0, 1e-6, 9e-4, 1.1e-3,
                            2e-3], 3)
            loc = np.stack([rho * np.cos(phi), rho * np.sin(phi), z], -1)
            if kind == 3:      # a vertex at the apex
                loc[0] = [0.0, 0.0, -x0[i] / ta[i] if ta[i] > 0 else 0.0]
            if kind == 4:      # degenerate: coincident or collinear
                loc[1] = loc[0] if r.random() < 0.5 else \
                    0.5 * (loc[0] + loc[2])
            tris.append(_to_world(loc, ro[i], rd[i], xh[i], e[i])
                        .reshape(9))
    tri = np.asarray(tris, np.float32)
    accepted, _, sph_cut, cut = _cone_cull(
        _t(tri), _t(ro), _t(rd), _t(xh), _t(e), _t(x0), _t(ta), _t(zmax))
    assert accepted > 50 and cut > 0.5 and sph_cut > 0.3


@pytest.mark.parametrize("seed", [0, 1])
def test_cone_cull_negative_x0_and_ta(seed):
    """Lanes the render never makes but the kernel accepts: x0 < 0 (the
    cone starts at an apex beyond zmin, and a plane ⊥ the axis between
    zmin and the apex still enters on the axis) and ta ≤ 0 (the radius
    shrinks along z and may change sign; the body compares r², so |r|
    counts). Triangles around the axis, ⊥ to it or not, in rotated
    frames."""
    r = np.random.default_rng(300 + seed)
    N = 48
    ro, rd, xh = _frame(r, N)
    e = r.choice([1.0, 0.7, 2.5], N).astype(np.float32)
    x0 = r.choice([-0.1, -0.02, -1e-3, 0.05], N).astype(np.float32)
    ta = r.choice([-0.1, -0.01, 0.0, 0.1], N).astype(np.float32)
    zmax = r.uniform(1.0, 5.0, N).astype(np.float32)
    tris = []
    for i in range(N):
        for _ in range(8):
            z = r.uniform(0.01, zmax[i], 3)
            if r.random() < 0.5:               # a plane ⊥ the axis
                z[:] = z[0]
            phi = r.uniform(0, 2 * np.pi) + np.array([0.0, 2.1, 4.2])
            rho = r.uniform(0.0, 0.15, 3)
            loc = np.stack([rho * np.cos(phi), rho * np.sin(phi), z], -1)
            tris.append(_to_world(loc, ro[i], rd[i], xh[i], e[i])
                        .reshape(9))
    accepted, _, _, cut = _cone_cull(
        _t(np.asarray(tris, np.float32)), _t(ro), _t(rd), _t(xh), _t(e),
        _t(x0), _t(ta), _t(zmax))
    assert accepted > 50 and cut > 0.3


def _beyond(r, delta, side, x0, ta, zmax):
    """Triangles in each lane's local frame (x0, ta, zmax (N, 1)) whose
    three vertices lie beyond (1 − delta) × the pair cull's margin on one
    side (0/1: x above / below, 2/3: y, 4: z above zmax, 5: z below
    zmin): 32 per lane, wide across the other two coordinates, the
    coordinate past the margin the same for all three vertices (a plane
    parallel to the side) or spread up to R. Returns (A, B, C) and the
    margin of each triangle as `_pair_may_enter` computes it."""
    N, M = x0.shape[0], 32
    zlo_eff, R, rinv = ck._lane_cull_terms(x0, ta, zmax, ZMIN)
    w = (2.0 * R + 0.05).numpy()[..., None]
    zl, zh = zlo_eff.numpy()[..., None] - 0.5, zmax.numpy()[..., None] + 0.5
    other = np.stack([r.uniform(-w, w, (N, M, 3)),
                      r.uniform(-w, w, (N, M, 3)),
                      r.uniform(zl, zh, (N, M, 3))], -1)
    flat = r.random((N, M, 1)) < 0.5
    u = np.where(flat, 0.0, r.uniform(0, 1, (N, M, 3)) * R.numpy()[..., None])
    k = side // 2
    sgn = -1.0 if side in (1, 3, 5) else 1.0
    start = zmax.numpy()[..., None] if side == 4 else \
        (ZMIN if side == 5 else 0.0)
    d = np.zeros((N, M, 1))
    for _ in range(6):                         # the margin grows with |v|
        v = other.copy()
        v[..., k] = start + sgn * (d + u)
        loc = [tuple(_t(v[:, :, p, c]) for c in range(3)) for p in range(3)]
        mag = torch.ones_like(loc[0][0])
        for c in (*loc[0], *loc[1], *loc[2]):
            mag = torch.fmax(mag, c.abs())
        top = torch.fmax(torch.fmax(loc[0][2], loc[1][2]), loc[2][2])
        pad = ck._cull_pad(ck._radius_bound(R, x0, ta, rinv, zlo_eff, top),
                           x0, ta, mag)
        d = ((1 - delta) * pad.double().numpy() * (1 + 1e-5))[..., None]
    return loc, pad


@pytest.mark.parametrize("delta", [0.0, 0.25, 0.5])
def test_cone_cull_margin_has_slack(delta):
    """A search at the margin: triangles whose vertices all lie beyond
    (1 − delta) × the pair cull's margin, on each of its six sides, wide
    and tilted so that the conic near point comes as close as it can. The
    body rejects every one even at half the margin (the derivation in
    csrc/cone_kernels.cu needs √3·R of its 4·R), and at the full margin
    the cull rejects them too. Lanes from narrow beams to ta = 0.4."""
    r = np.random.default_rng(int(400 + 100 * delta))
    N = 96
    x0 = _t(r.choice([0.0, 1e-6, 1e-3, 0.05, 0.3], (N, 1)))
    ta = _t(r.choice([0.0, 1e-4, 0.01, 0.15, 0.4], (N, 1)))
    zmax = _t(r.uniform(0.5, 6.0, (N, 1)))
    for side in range(6):
        (A, B, C), pad = _beyond(r, delta, side, x0, ta, zmax)
        z = ck._minz_block(A, B, C, x0, ta, zmax, ZMIN)
        assert (z >= ck.BIG).all(), f"side {side}: the body enters"
        kept = ck._pair_may_enter(A, B, C, x0, ta, zmax, ZMIN)
        assert (pad > 0).all()
        if delta == 0.0:
            assert not kept.any(), f"side {side}: beyond the margin, kept"


def test_kernel_tables_reorder_the_triangles():
    """K3's and K2's copies of the triangles are one permutation of the
    bake order (the ids), with the bounds of their own tiles, K3's rows
    zero-padded to a multiple of 4; the order puts the box's large walls
    last and makes the icosphere's tiles far more compact than the bake
    order's."""
    geo, _ = _render_scene_tris()
    T = geo.num_tris
    cone, ray = geo.cone_table, geo.ray_table
    ids = cone.ids.long()
    assert cone.ids.dtype == ray.ids.dtype == torch.int32
    assert torch.equal(cone.ids, ray.ids)
    assert torch.equal(ids.sort().values, torch.arange(T))
    assert cone.tris.shape == (T + -T % 4, 9)
    assert torch.equal(cone.tris[:T], geo.cone_tris[ids])
    odd = ck.cone_table(geo.cone_tris[:5], torch.arange(5)).tris
    assert odd.shape == (8, 9) and not odd[5:].any()
    assert torch.equal(ray.feat, geo.tri_feat[ids])
    assert torch.equal(cone.tiles, ck.tile_spheres(cone.tris[:T]))
    assert torch.equal(cone.spheres, ck.tri_spheres(cone.tris[:T]))
    assert torch.equal(ray.boxes, rk.tile_boxes(
        geo.p0[ids], geo.e1[ids], geo.e2[ids], geo.mxu_center))
    # the 12 walls of the box (the first 12 baked) come last
    assert set(ids[-12:].tolist()) == set(range(12))
    assert rk.tile_order(geo.p0[:0], geo.e1[:0], geo.e2[:0]).shape == (0,)
    # a 20,480-triangle icosphere bakes each level of its subdivision in
    # turn, so every baked tile spans the sphere; the order's do not
    soup = mesh.sphere([0.0, 0.0, 0.0], 1.0, tessellation=96)
    v = torch.from_numpy(soup.positions.astype(np.float32))
    p0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    tri = ck.cone_tris(p0, e1, e2)
    baked = ck.tile_spheres(tri)[:, 3]
    ordered = ck.tile_spheres(tri[rk.tile_order(p0, e1, e2)])[:, 3]
    assert baked.min() > 0.9 and ordered.mean() < 0.4


@pytest.mark.parametrize("group", [1, ck.TILE])
def test_bounding_spheres_hold_their_triangles(group):
    """The spheres of the tiles and of the triangles contain every vertex
    (in f64), with the f32 centre."""
    r = np.random.default_rng(3)
    tri = _t(r.normal(size=(700, 9)) * 10 + 100)
    make = {1: ck.tri_spheres, ck.TILE: ck.tile_spheres}[group]
    sph = make(tri)
    assert sph.shape == (-(-700 // group), 4) and sph.dtype == torch.float32
    v = tri.double().reshape(-1, 3, 3)
    tile = torch.arange(700) // group
    dist = (v - sph[tile, None, :3].double()).norm(dim=-1).amax(1)
    assert (dist <= sph[tile, 3].double()).all()
    assert make(tri[:0]).shape == (0, 4)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def _soup(r, T, clustered):
    """A random soup; `clustered` puts it in K2's tile order
    (`tile_order`), so that tiles are compact, as the kernel reads it."""
    p0 = r.normal(size=(T, 3)) * 2 + 5.0
    e = r.normal(size=(2, T, 3)) * (0.3 if clustered else 1.0)
    out = [_t(x) for x in (p0, e[0], e[1])]
    if clustered:
        order = rk.tile_order(*out)
        out = [x[order] for x in out]
    return out


@pytest.mark.parametrize("clustered", [False, True])
def test_anyhit_tile_cull(clustered):
    """For every ray and 256-triangle tile in which the pair test of
    `_anyhit_ref` finds a hit, the tile-box twin says the segment may meet
    the box: random rays, short segments, negative tmin, exclusions, and
    rays grazing the triangles' planes."""
    r = np.random.default_rng(21 + clustered)
    T, N = 900, 768
    p0, e1, e2 = _soup(r, T, clustered)
    center = p0.mean(0)
    feat = rk.tri_features(p0, e1, e2, center)
    boxes = rk.tile_boxes(p0, e1, e2, center)
    assert boxes.shape == (4, 8)
    ro = _t(r.normal(size=(N, 3)) * 3 + 5.0)
    rd = _unit(r, N)
    # a third graze a triangle's plane: direction ⟂ its normal, up to 1e-6
    g = r.integers(0, T, N)
    n = torch.linalg.cross(e1[g], e2[g]).numpy()
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    graze = rd - (rd * n).sum(-1, keepdims=True) * n + 1e-6 * n
    graze /= np.linalg.norm(graze, axis=-1, keepdims=True)
    sel = r.random(N) < 1 / 3
    rd = np.where(sel[:, None], graze, rd).astype(np.float32)
    ro = torch.where(_t(sel)[:, None].bool(),
                     p0[g] + 0.3 * (e1[g] + e2[g]) - 2.0 * _t(rd), ro)
    rd = _t(rd)
    tmin = _t(np.where(r.random(N) < 0.2, -5.0, 1e-4))
    tmax = _t(r.choice([0.3, 2.0, 6.0, 1e30], N))
    ex = _t(np.where(r.random((N, 3)) < 0.3, r.integers(0, T, (N, 3)), -1),
            torch.int32)
    may = rk._tile_box_may_hit(boxes, center, ro, rd, tmin, tmax)
    rf = rk._ray_features(ro, rd, center)
    hits = 0
    for base in range(0, T, rk.TILE):
        _, hit, _ = rk._tile_hits(rf, feat[base:base + rk.TILE], base, tmin,
                                  tmax, ex)
        hit = hit.any(1)
        assert not (hit & ~may[:, base // rk.TILE]).any(), \
            "tile box drops a hit"
        hits += int(hit.sum())
    assert hits > 50
    if clustered:
        assert (~may).float().mean() > 0.3


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def _closest_scene(kind, r):
    """(p0, e1, e2, ro, rd, ex, big) of a K1 scene; `big` are the ids of
    the big triangles, which tile_order puts last. "random": a clustered
    soup with twelve triangles 40× the others' extent among them, and
    random rays. "render": the box (its twelve walls are the big ones)
    with an icosphere inside it; camera rays from the eye, and rays
    leaving points on the triangles, each excluding its own, as a bounce
    makes them."""
    if kind == "random":
        T, N = 700, 600
        p0, e1, e2 = _soup(r, T, clustered=False)
        big = r.choice(T, 12, replace=False)
        e1[big], e2[big] = e1[big] * 40, e2[big] * 40
        ro = _t(r.normal(size=(N, 3)) * 3 + 5.0)
        ex = torch.full((N, 3), -1, dtype=torch.int32)
        return p0, e1, e2, ro, _t(_unit(r, N)), ex, big
    geo, _ = _render_scene_tris()
    N, T = 640, geo.num_tris
    pick = r.integers(0, T, N)
    u = r.random((N, 2))
    u = np.where(u.sum(1, keepdims=True) > 1, 1 - u, u)
    tg = geo.tri_geom.numpy()
    ro = tg[pick, 0:3] + u[:, :1] * tg[pick, 3:6] + u[:, 1:] * tg[pick, 6:9]
    rd = _unit(r, N)
    cam = r.random(N) < 0.25
    ro[cam] = [0.0, 1.0, 3.2]
    rd[cam, 2] = -np.abs(rd[cam, 2]) - 1.0
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ex = torch.full((N, 3), -1, dtype=torch.int32)
    ex[:, 0] = _t(np.where(cam, -1, pick), torch.int32)
    return geo.p0, geo.e1, geo.e2, _t(ro), _t(rd), ex, np.arange(12)


@pytest.mark.parametrize("kind", ["random", "render"])
def test_closest_tile_cull_keeps_the_winner(kind):
    """K1 culls a tile when no segment [tmin, best t] of the warp meets its
    padded box. With the best t at its final value, the closest t, the
    twin `_tile_box_may_hit` keeps every tile in which the pair test
    finds a hit at t <= the closest t (ties included), so the winner's
    tile above all: on random rays among big and small triangles, and on
    render-like rays in the box with an icosphere inside it."""
    r = np.random.default_rng(40 + (kind == "render"))
    p0, e1, e2, ro, rd, ex, big = _closest_scene(kind, r)
    T, N = p0.shape[0], ro.shape[0]
    center = p0.mean(0)
    feat = rk.tri_features(p0, e1, e2, center)
    order = rk.tile_order(p0, e1, e2)
    table = rk.ray_table(p0, e1, e2, center, feat, order)
    pos = torch.empty(T, dtype=torch.long)
    pos[order] = torch.arange(T)
    assert (pos[big] // rk.TILE == (T - 1) // rk.TILE).all()
    tmin = torch.full((N,), 1e-4)
    tmax = torch.full((N,), 1e30)
    t, tri = rk._closest_ref(feat, center, ro, rd, tmin, tmax, ex)
    hit = tri >= 0
    assert hit.float().mean() > 0.5
    # the big triangles give many rays their closest hit
    assert np.isin(tri[hit].numpy(), big).mean() > 0.2
    t_hi = torch.where(hit, t, tmax)
    may = rk._tile_box_may_hit(table.boxes, center, ro, rd, tmin, t_hi)
    rf = rk._ray_features(ro, rd, center)
    win_tile = pos[tri.clamp_min(0).long()] // rk.TILE
    assert may[hit, win_tile[hit]].all(), "the winner's tile is culled"
    for base in range(0, T, rk.TILE):
        _, ok, _ = rk._tile_hits(rf, table.feat[base:base + rk.TILE],
                                 base, tmin, t_hi, ex)
        ok = ok.any(1)
        assert not (ok & ~may[:, base // rk.TILE]).any(), \
            "a tile with a hit at t <= the closest t is culled"
    # the shrunk segments cull more tiles than the whole rays
    full = rk._tile_box_may_hit(table.boxes, center, ro, rd, tmin, tmax)
    assert may.float().mean() < full.float().mean()


def tie_soup(smaller_left):
    """Two coincident triangles (the same edges in the plane z = 2,
    shifted by 0.5 along x, so that the part x > 0.5, x + y < 1 lies in
    both and every ray through it meets both at the same t) whose
    centroids tile_order puts into different tiles: 255 small filler
    triangles on each side. `smaller_left` gives the left one the smaller
    bake id. Returns (p0, e1, e2, ids of the left and right one)."""
    r = np.random.default_rng(50)
    fill = [np.c_[r.uniform(lo, lo + 5, 255), r.uniform(-2, 2, 255),
                  r.uniform(-1, 1, 255)] for lo in (-10.0, 5.0)]
    p0 = np.concatenate(fill + [[[0.0, 0.0, 2.0], [0.5, 0.0, 2.0]]])
    e1 = np.concatenate([r.normal(size=(510, 3)) * 0.05,
                         [[1.0, 0.0, 0.0]] * 2])
    e2 = np.concatenate([r.normal(size=(510, 3)) * 0.05,
                         [[0.0, 1.0, 0.0]] * 2])
    left, right = (3, 400) if smaller_left else (400, 3)
    ids = np.delete(np.arange(512), [left, right])
    rows = np.empty(512, np.int64)         # bake id → row above
    rows[ids] = r.permutation(510)
    rows[left], rows[right] = 510, 511
    out = [_t(x[rows].astype(np.float32)) for x in (p0, e1, e2)]
    return (*out, left, right)


def tie_rays(n, seed=51):
    """n rays straight down onto the common part from z = 5, on a grid of
    1/64: with the scene's center at 0 every side, tn and d·N is exact,
    so both triangles give t = 3 bit for bit, whatever order a product
    sums in."""
    r = np.random.default_rng(seed)
    ro = np.c_[r.integers(34, 45, n) / 64, r.integers(2, 19, n) / 64,
               np.full(n, 5.0)]
    rd = np.tile([0.0, 0.0, -1.0], (n, 1))
    return _t(ro), _t(rd)


@pytest.mark.parametrize("smaller_left", [False, True])
def test_closest_hit_ties_across_tiles(smaller_left):
    """Coincident triangles at the same t whose bake ids lie in different
    tiles of tile_order: the closest hit is the smaller id, whichever tile
    holds it (the kernel walks the tiles in its own order and compares
    (t, id) words)."""
    p0, e1, e2, left, right = tie_soup(smaller_left)
    assert (left < right) == smaller_left
    order = rk.tile_order(p0, e1, e2)
    pos = torch.empty(512, dtype=torch.long)
    pos[order] = torch.arange(512)
    assert pos[left] // rk.TILE != pos[right] // rk.TILE
    center = torch.zeros(3)
    feat = rk.tri_features(p0, e1, e2, center)
    ro, rd = tie_rays(256)
    N = ro.shape[0]
    t, tri = rk.closest_hit(feat, center, ro, rd, torch.full((N,), 1e-4),
                            torch.full((N,), 1e30),
                            torch.full((N, 3), -1, dtype=torch.int32),
                            table=rk.ray_table(p0, e1, e2, center, feat,
                                               order))
    assert (tri == min(left, right)).all()
    assert (t == 3.0).all()
