"""The plain reference against hand-worked answers at tiny sizes, and
against the program where the reference rebuilds what the program
derives (the wedge edges and their clusters)."""

from __future__ import annotations

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from wtbench.reference import cones, edges, film, rays, tf32, utd

REPO = Path(__file__).resolve().parents[2]
f64 = torch.float64

# one triangle in the plane z = 0 and one in z = 1, both over [0, 1]²
TRIS = torch.tensor([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[0, 0, 1], [1, 0, 1], [0, 1, 1]]], dtype=f64)


def rows(ro, rd, tmin=1e-4, tmax=1e30, ex=(-1, -1, -1)):
    ro = torch.tensor(ro, dtype=f64)
    rd = torch.tensor(rd, dtype=f64)
    n = ro.shape[0]
    return (ro, rd, torch.full((n,), tmin, dtype=f64),
            torch.full((n,), tmax, dtype=f64),
            torch.tensor([ex] * n, dtype=torch.long))


def test_closest_hit_by_hand():
    args = rows([[0.2, 0.2, 2.0], [0.2, 0.2, 0.5], [0.9, 0.9, 2.0]],
                [[0, 0, -1], [0, 0, -1], [0, 0, -1]])
    q = rays.queries(TRIS, *args)
    assert q["tri"].tolist() == [1, 0, -1]
    assert q["t"][:2].tolist() == pytest.approx([1.0, 0.5])
    assert math.isinf(q["t"][2])
    # the foot (0.2, 0.2) lies 0.2 from the legs and 0.6/√2 from the
    # hypotenuse
    assert q["margin"][0] == pytest.approx(0.2)


def test_exclusion_ties_and_window():
    # excluding the upper triangle finds the lower one
    q = rays.queries(TRIS, *rows([[0.2, 0.2, 2.0]], [[0, 0, -1]],
                                 ex=(1, -1, -1)))
    assert q["tri"].tolist() == [0] and q["t"].item() == pytest.approx(2.0)
    # a duplicate of triangle 0 ties: the least id wins
    twice = torch.cat([TRIS[:1], TRIS[:1]])
    q = rays.queries(twice, *rows([[0.2, 0.2, 1.0]], [[0, 0, -1]]))
    assert q["tri"].tolist() == [0]
    # tmax short of the plane: a miss; any-hit robust and possible agree
    q = rays.queries(TRIS, *rows([[0.2, 0.2, 2.0]], [[0, 0, -1]],
                                 tmax=0.5), tol=1e-3)
    assert q["tri"].tolist() == [-1]
    assert not q["robust"].item() and not q["possible"].item()


def test_crack_is_possible_not_robust():
    # a ray through the hypotenuse x + y = 1 of triangle 0
    q = rays.queries(TRIS[:1], *rows([[0.5, 0.5, 1.0]], [[0, 0, -1]]),
                     tol=1e-6)
    assert q["possible"].item() and not q["robust"].item()


def test_pair():
    ro, rd, *_ = rows([[0.2, 0.2, 2.0], [0.2, 0.2, 2.0]],
                      [[0, 0, -1], [0, 0, -1]])
    t, m = rays.pair(TRIS, ro, rd, torch.tensor([0, 1]))
    assert t.tolist() == pytest.approx([2.0, 1.0])
    assert (m > 0).all()


def lane(ro, rd, x0, ta, zmax, xh=(1.0, 0.0, 0.0), e=1.0, zmin=1e-7):
    n = len(ro)
    t = lambda v: torch.tensor(v, dtype=f64)
    return dict(ro=t(ro), rd=t(rd), xh=t([xh] * n), e=t([e] * n),
                x0=t([x0] * n), ta=t([ta] * n), zmax=t([zmax] * n),
                zmin=zmin)


def test_cone_meets_a_plane_triangle_first_at_its_rim():
    # a cone along −z from z = 2 with radius 0.1 + 0.5·z: the lower
    # triangle's plane is 2 away, and the nearest part of triangle 0 to
    # the axis through (−0.5, 0.2) is its leg x = 0, 0.5 from the axis:
    # 0.1 + 0.5·z = 0.5 at z = 0.8, short of the plane; the plane at z = 2
    # meets it, and so does the upper triangle's plane at z = 1 (radius
    # 0.6 > 0.5)
    L = lane([[-0.5, 0.2, 2.0]], [[0, 0, -1]], 0.1, 0.5, 10.0)
    z = cones.triangle_entries(TRIS, L)
    assert z[0].tolist() == pytest.approx([2.0, 1.0])
    # a narrow cylinder misses both
    L = lane([[-0.5, 0.2, 2.0]], [[0, 0, -1]], 0.1, 0.0, 10.0)
    assert torch.isinf(cones.triangle_entries(TRIS, L)).all()


def test_cone_entry_inside_a_tilted_triangle():
    # a triangle leaning across the axis: the entry is where the cone's
    # surface first touches the plane (the section's nearest point)
    tri = torch.tensor([[[-1, -1, 1], [1, -1, 2], [0, 2, 1.5]]], dtype=f64)
    L = lane([[0.0, 0.0, 0.0]], [[0, 0, 1]], 0.0, 0.1, 10.0)
    z = cones.triangle_entries(tri, L).item()
    # the plane z = 1.5 + 0.5·x: the cone x² + y² ≤ (0.1 z)² first reaches
    # it on the side x < 0, at z = 1.5 − 0.05·z → z = 1.5/1.05
    assert z == pytest.approx(1.5 / 1.05, rel=1e-9)
    # a grown cone enters no later, a narrowed one no earlier
    assert cones.triangle_entries(tri, L, grow=1e-3).item() <= z
    assert cones.triangle_entries(tri, L, grow=-1e-3).item() >= z


def test_cone_matches_sampled_points():
    g = torch.Generator().manual_seed(3)
    tris = torch.rand((40, 3, 3), generator=g, dtype=f64) * 4 - 2
    L = lane([[0.1, -0.2, -3.0]], [[0, 0, 1]], 0.3, 0.2, 6.0,
             xh=(0.6, 0.8, 0.0), e=1.7)
    z = cones.triangle_entries(tris, L)[0]
    u = torch.rand((200000, 2), generator=g, dtype=f64)
    flip = u.sum(1) > 1
    u[flip] = 1 - u[flip]
    for t in range(len(tris)):
        A, B, C = tris[t]
        P = A + u[:, :1] * (B - A) + u[:, 1:] * (C - A)
        loc = cones.local(P, L, "f64")[0]
        r = 0.3 + 0.2 * loc[:, 2]
        inside = (loc[:, 0] ** 2 + loc[:, 1] ** 2 <= r * r) \
            & (loc[:, 2] >= 1e-7) & (loc[:, 2] <= 6.0)
        if inside.any():
            # sampled points lie no lower than the exact entry, and close
            assert loc[inside, 2].min() >= z[t] - 1e-9
            assert loc[inside, 2].min() <= z[t] + 0.05
        else:
            assert math.isinf(z[t]) or z[t] > -1


def test_segment_entry():
    L = lane([[0.0, 0.0, 0.0]], [[0, 0, 1]], 0.0, 1.0, 10.0)
    p0 = torch.tensor([[-5.0, 0.5, 2.0]], dtype=f64)
    p1 = torch.tensor([[5.0, 0.5, 2.0]], dtype=f64)
    assert cones.segment_entries(p0, p1, L).item() == pytest.approx(2.0)
    p1 = torch.tensor([[0.0, 0.0, 5.0]], dtype=f64)
    p0 = torch.tensor([[0.0, 3.0, 1.0]], dtype=f64)
    # along (0, 3 − 3s, 1 + 4s): inside where 3 − 3s ≤ 1 + 4s, s ≥ 2/7
    assert cones.segment_entries(p0, p1, L).item() == pytest.approx(1 + 8 / 7)
    # wholly outside the cone
    p0 = torch.tensor([[4.0, 0.0, 1.0]], dtype=f64)
    p1 = torch.tensor([[4.0, 1.0, 2.0]], dtype=f64)
    assert math.isinf(cones.segment_entries(p0, p1, L).item())


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.0])
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]


def test_film_splat_by_hand():
    # one sample at a pixel's centre: the developed image is its value
    # around it, and 0 where no weight falls
    pos = torch.tensor([[3.5, 3.5]])
    vals = torch.tensor([[1.0, 2.0, 3.0]])
    img = film.camera_image([(pos, vals, torch.tensor([True]))], 7, 7, 3,
                            0.25)
    assert img[3, 3].tolist() == pytest.approx([1.0, 2.0, 3.0])
    assert img[0, 0].tolist() == [0.0, 0.0, 0.0]
    pos = torch.tensor([[2.5, 2.5]])
    # a beam's weights add to one over the map
    beams = [(pos, torch.tensor([0.7]), vals[:, :1], torch.tensor([True]))]
    m = film.coverage_map(beams, [], 5, 5, 1, 2.0)
    assert m.sum().item() == pytest.approx(0.5)
    pts = [(torch.tensor([[0.5, 4.9], [9.0, 1.0]]),
            torch.tensor([[2.0], [5.0]]), torch.tensor([True, True]))]
    m = film.coverage_map([], pts, 5, 5, 1, 2.0)
    assert m[4, 0, 0].item() == 1.0 and m.sum().item() == 1.0


def test_utd_direct_only_and_one_edge():
    n, K = 2, 1
    ap = dict(v=np.zeros((n, K, 3)), half_l=np.ones((n, K)),
              nff=np.tile([0.0, 1.0, 0.0], (n, K, 1)),
              tff=np.tile([1.0, 0.0, 0.0], (n, K, 1)),
              nbf=np.tile([-1.0, 0.0, 0.0], (n, K, 1)),
              alpha=np.full((n, K), math.pi / 2), w=np.ones((n, K)),
              valid=np.array([[False], [True]]))
    src = np.array([[-3.0, 2.0, 0.1]] * n)
    dst = np.array([[-3.0, -1.0, 0.3]] * n)
    ts, th, scale = utd.coherent_sum(ap, 200.0, src, dst,
                                     np.array([True, False]),
                                     np.ones((n, K), bool))
    assert ts[0] == 1 and th[0] == 1 and scale[0] == 1
    assert abs(ts[1]) > 0 and scale[1] > 0 and ts[1] != th[1]


def test_utd_matches_the_program_on_random_slots():
    from wave_tracer_tpu_torch.wave import fsd
    g = np.random.default_rng(1)
    n, K = 64, 4
    e = np.array([0.0, 0.0, 1.0])
    ang = g.uniform(0.3, 1.2, (n, K))
    nff = np.stack([np.zeros_like(ang), np.ones_like(ang),
                    np.zeros_like(ang)], -1)
    tff = np.stack([np.ones_like(ang), np.zeros_like(ang),
                    np.zeros_like(ang)], -1)
    nbf = np.stack([-np.cos(ang), -np.sin(ang), np.zeros_like(ang)], -1)
    ap = dict(v=g.normal(0, 0.2, (n, K, 3)), half_l=np.full((n, K), 2.0),
              nff=nff, tff=tff, nbf=nbf, alpha=np.pi - ang,
              w=g.uniform(0.5, 1, (n, K)), valid=g.random((n, K)) < 0.8)
    src = np.column_stack([g.uniform(-6, -3, n), g.uniform(2, 5, n),
                           g.uniform(-1, 1, n)])
    dst = np.column_stack([g.uniform(3, 6, n), g.uniform(-5, 5, n),
                           g.uniform(-1, 1, n)])
    k = 20.0
    direct = g.random(n) < 0.5
    unsh = g.random((n, K)) < 0.9
    ts, th, scale = utd.coherent_sum(ap, k, src, dst, direct, unsh)
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    apt = fsd.FsdAperture(v=T(ap["v"]), half_l=T(ap["half_l"]),
                          nff=T(nff), tff=T(tff), nbf=T(nbf),
                          alpha=T(ap["alpha"]),
                          edge_idx=torch.zeros((n, K), dtype=torch.int32),
                          valid=torch.as_tensor(ap["valid"]), w=T(ap["w"]))
    kk = torch.full((n,), k)
    ev = fsd.fsd_eval(apt, kk, T(src), T(dst))
    pts, pth = fsd.coherent_sum(ev, kk, T(src), T(dst),
                                torch.as_tensor(direct),
                                torch.as_tensor(unsh))
    some = scale > 0
    gap = (np.abs(pts.numpy() - ts) + np.abs(pth.numpy() - th))[some] / 2 \
        / scale[some]
    assert some.sum() > n // 2
    assert np.median(gap) < 1e-4 and gap.max() < 1e-2


def test_wedges_and_clusters_match_the_bake():
    from wave_tracer_tpu_torch.accel import edges as pedges
    from wtbench.configs import city_10ghz
    from wtbench.geometry import triangles
    cfg = json.loads((REPO / "wtbench/configs/city_10ghz.json").read_text())
    parts = city_10ghz.parts(cfg)
    tris = triangles(parts).astype(np.float32)
    soup_n = np.concatenate([np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
                             for t in [tris.astype(np.float64)]])
    soup_n /= np.linalg.norm(soup_n, axis=-1, keepdims=True)
    mine = edges.wedges(tris)
    theirs = pedges.classify_edges(tris, soup_n.astype(np.float32))
    assert len(mine["p0"]) == cfg["wedge_edges"] == len(theirs["p0"])
    assert np.array_equal(mine["p0"], theirs["p0"])
    assert np.array_equal(mine["p1"], theirs["p1"])
    assert np.array_equal(mine["center"], theirs["center"])
    cl, pcl = edges.clusters(mine), pedges.build_edge_clusters(theirs)
    for k in ("center", "radius", "start", "count", "order"):
        assert np.array_equal(np.asarray(cl[k]), pcl[k]), k


def test_reference_imports_nothing_of_the_program():
    for p in (REPO / "wtbench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in {"math", "numpy", "torch",
                                              "scipy", "wtbench",
                                              "__future__", "warnings"}, \
                    (p.name, name)
                if name.startswith("wtbench"):
                    assert name.startswith("wtbench.reference"), (p, name)
