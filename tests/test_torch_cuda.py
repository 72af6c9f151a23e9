"""K1/K2/K3 and the classical, wave and coverage renders on a CUDA card
against the plain torch versions. Marked `gpu`: each test skips without a
card. This file imports no
jax, so it also runs on GPU hosts without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from wave_tracer_tpu_torch.accel import cone_kernels as ck
from wave_tracer_tpu_torch.accel import ray_kernels as rk
from wave_tracer_tpu_torch.integrator.traversal import segment_boundaries
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene import build_scene
from wave_tracer_tpu_torch.scene.procedural import make_box_scene
from test_torch_cull import tie_rays, tie_soup


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _soup_rays(dev, T=3000, N=4096, seed=0):
    r = np.random.default_rng(seed)
    p0 = (r.normal(size=(T, 3)) * 2 + 5.0).astype(np.float32)
    e1 = r.normal(size=(T, 3)).astype(np.float32)
    e2 = r.normal(size=(T, 3)).astype(np.float32)
    ro = (r.normal(size=(N, 3)) * 3 + 5.0).astype(np.float32)
    rd = r.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    t = [torch.from_numpy(x).to(dev) for x in (p0, e1, e2, ro, rd)]
    center = t[0].mean(0)
    feat = rk.tri_features(t[0], t[1], t[2], center)
    table = rk.ray_table(t[0], t[1], t[2], center, feat,
                         rk.tile_order(t[0], t[1], t[2]))
    ex = torch.from_numpy(r.integers(-1, T, (N, 3)).astype(np.int32)).to(dev)
    return feat, table, center, t[3], t[4], ex


@pytest.mark.gpu
def test_kernels_match_twins(cuda):
    feat, table, center, ro, rd, ex = _soup_rays(cuda)
    N = ro.shape[0]
    r = np.random.default_rng(1)
    # a negative tmin admits hits behind the origin (negative t), which the
    # kernel's cross-chunk merge must order like positive ones
    for tmin_v, tmax_v in ((1e-4, 1e30), (1e-4, 3.0), (-20.0, 1e30)):
        tmin = torch.full((N,), tmin_v, device=cuda)
        tmax = torch.full((N,), tmax_v, device=cuda)
        args = (feat, center, ro, rd, tmin, tmax, ex)
        before = dict(rk.LAUNCHES)
        tk, ik = rk.closest_hit(*args, table=table)
        tr, ir = rk._closest_ref(*args)
        assert (ik == ir).float().mean().item() >= 0.999
        both = (ik == ir) & (ir >= 0)
        torch.testing.assert_close(tk[both], tr[both], rtol=1e-4, atol=1e-5)
        assert (tr[both] < 0).any().item() == (tmin_v < 0)
        occ = rk.any_hit(*args, table=table)
        ref = rk._anyhit_ref(*args)
        assert (occ == ref).float().mean().item() >= 0.999
        assert rk.LAUNCHES["closest"] == before["closest"] + 1
        assert rk.LAUNCHES["anyhit"] == before["anyhit"] + 1
        # need masks: needed rows as before, the rest False
        for need in (torch.from_numpy(r.random(N) < 0.1).to(cuda),
                     torch.zeros(N, dtype=torch.bool, device=cuda)):
            occ_n = rk.any_hit(*args, need, table=table)
            assert not occ_n[~need].any().item()
            if need.any().item():
                assert (occ_n[need] == ref[need]).float().mean().item() \
                    >= 0.999
        # K1's walk and culls, with its tiles split (4,096 rays are fewer
        # blocks than the grid), change no word
        words = rk._launch_closest(feat, table, *args[1:], every_pair=True)
        assert torch.equal(rk._launch_closest(feat, table, *args[1:]), words)


@pytest.mark.gpu
def test_render_cuda_matches_cpu(cuda):
    scene = make_box_scene(res=32, spp=2)
    scene.integrator.fsd = False
    built = build_scene(scene, device=cuda)
    img_c, st_c = render_scene(built, device="cuda")
    img_h, st_h = render_scene(built, device="cpu")
    scale = np.maximum(np.abs(img_h), np.abs(img_h).mean())
    assert (np.abs(img_c - img_h) <= 1e-3 * scale).all(-1).mean() >= 0.98
    assert st_c["device_counters"]["rays_cast"] \
        == st_h["device_counters"]["rays_cast"]


@pytest.mark.gpu
def test_cone_kernel_matches_plain(cuda):
    """K3 against _minz_ref on seeded random cones, at N a multiple of the
    256-lane block and not, with and without the triangle-range split;
    test_mxu_cone.py's bars."""
    r = np.random.default_rng(7)
    for T, N in ((700, 256), (3000, 4100), (12, 20000)):
        p0 = r.uniform(-4, 4, (T, 3)).astype(np.float32)
        e = r.uniform(-1, 1, (2, T, 3)).astype(np.float32)
        ro = r.uniform(-5, 5, (N, 3)).astype(np.float32)
        rd = r.normal(size=(N, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        xh = np.cross(rd, r.normal(size=(N, 3))).astype(np.float32)
        xh /= np.linalg.norm(xh, axis=-1, keepdims=True)
        t = [torch.from_numpy(x).to(cuda) for x in (p0, e[0], e[1], ro, rd,
                                                     xh)]
        lane = [torch.from_numpy(r.uniform(lo, hi, N).astype(np.float32))
                .to(cuda) for lo, hi in ((0.6, 1.0), (0.01, 0.3),
                                         (0.01, 0.2))]
        zmax = torch.full((N,), 30.0, device=cuda)
        ex = torch.from_numpy(r.integers(-1, T, N).astype(np.int32)).to(cuda)
        lam = torch.full((N,), 0.05, device=cuda)
        args = (ck.cone_tris(*t[:3]), *t[3:], *lane, zmax, ex,
                segment_boundaries(lam), 1e-7)
        order = rk.tile_order(*t[:3])
        _cone_matches_plain(args, ck.cone_table(args[0], order))


def _cone_matches_plain(args, table):
    """K3 against _minz_ref: bit-equal minima and counts (the culls skip
    only pairs the body rejects), one launch counted; the counting build
    returns the same, with consistent counters."""
    before = ck.LAUNCHES["cone_minz"]
    zc, cnt = ck.cone_minz(*args, table=table)
    zr, cr = ck._minz_ref(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cone_minz"] == before + 1
    assert torch.isfinite(zr).any().item()
    assert torch.equal(zc, zr) and torch.equal(cnt, cr)
    stats = torch.zeros((4,), dtype=torch.int64, device=zc.device)
    zs, cs = ck.cone_minz(*args, table=table, stats=stats)
    assert torch.equal(zs, zc) and torch.equal(cs, cnt)
    tested, entered, witer, witer_in = stats.tolist()
    assert entered <= tested <= args[1].shape[0] * args[0].shape[0]
    assert witer_in <= witer and entered >= int(cnt.sum())


@pytest.mark.gpu
def test_cone_kernel_negative_x0_and_ta(cuda):
    """K3 on lanes with x0 < 0 or ta <= 0 (which the render never makes):
    its culls must still keep every pair the body accepts, so it stays
    bit-equal to its plain version; triangles near and ⊥ the axis."""
    r = np.random.default_rng(13)
    T, N = 1500, 1024
    ro = r.uniform(-1, 1, (N, 3)).astype(np.float32)
    rd = np.tile(np.float32([0.0, 0.0, 1.0]), (N, 1))
    xh = np.tile(np.float32([1.0, 0.0, 0.0]), (N, 1))
    c = r.uniform(-1.2, 1.2, (T, 3))
    c[:, 2] = r.uniform(0.0, 4.0, T)
    tri = c[:, None] + r.normal(size=(T, 3, 3)) * 0.1
    flat = r.random(T) < 0.5
    tri[flat, :, 2] = tri[flat, :1, 2]
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda)
         for x in (tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                   ro, rd, xh)]
    pick = [r.choice(v, N).astype(np.float32) for v in
            ([1.0, 0.7], [-0.1, -0.02, 0.05], [-0.1, 0.0, 0.1])]
    lane = [torch.from_numpy(x).to(cuda) for x in pick]
    args = (ck.cone_tris(*t[:3]), *t[3:], *lane,
            torch.full((N,), 5.0, device=cuda),
            torch.full((N,), -1, dtype=torch.int32, device=cuda),
            segment_boundaries(torch.full((N,), 0.05, device=cuda)), 1e-7)
    _cone_matches_plain(args, ck.cone_table(args[0], rk.tile_order(*t[:3])))


@pytest.mark.gpu
def test_cone_kernel_narrow_cones(cuda):
    """K3 on render-like narrow cones (FSD restart beams at visible
    wavelengths from points on the surfaces) over the box + icosphere
    scene: bit-equal to its plain version."""
    from wave_tracer_tpu_torch.wave import sourcing
    scene = make_box_scene(res=8, spp=1, icosphere=True)
    geo = build_scene(scene, device=cuda).data.geo
    r = np.random.default_rng(9)
    N, T = 2048, geo.num_tris
    tg = geo.tri_geom.cpu().numpy()
    pick = r.integers(0, T, N)
    u = r.random((N, 2))
    u = np.where(u.sum(1, keepdims=True) > 1, 1 - u, u)
    ro = (tg[pick, 0:3] + u[:, :1] * tg[pick, 3:6]
          + u[:, 1:] * tg[pick, 6:9]).astype(np.float32)
    rd = r.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(cuda, dtype)
    lam = t(r.uniform(380e-9, 720e-9, N))
    env = sourcing.restart_envelope(t(rd), t(10 ** r.uniform(-4, -2, N)),
                                    2 * np.pi / lam)
    zmax = t(np.where(r.random(N) < 0.5, r.uniform(0.05, 4.0, N),
                      8 * scene.world_radius()))
    args = (geo.cone_tris, t(ro), t(rd), env.x.contiguous(), env.e, env.x0,
            env.ta, zmax, t(pick, torch.int32), segment_boundaries(lam),
            1e-7)
    _cone_matches_plain(args, geo.cone_table)


@pytest.mark.gpu
def test_wave_render_cuda_matches_cpu(cuda):
    scene = make_box_scene(res=16, spp=2)
    scene.integrator.fsd = True
    scene.integrator.max_depth = 5
    built = build_scene(scene, device=cuda)
    img_c, st_c = render_scene(built, device="cuda")
    img_h, st_h = render_scene(built, device="cpu")
    assert st_c["mode"] == st_h["mode"] == "wave-compact"
    np.testing.assert_allclose(img_c.mean((0, 1)), img_h.mean((0, 1)),
                               rtol=0.02)
    assert np.corrcoef(img_c.ravel(), img_h.ravel())[0, 1] >= 0.999


@pytest.mark.gpu
def test_closest_hit_need_and_carry_on_card(cuda):
    """K1 with a need mask and a carried hit per row: needed rows hold the
    words of tracing every row, the others their carried (t, tri) bit for
    bit; an empty mask traces nothing."""
    feat, table, center, ro, rd, ex = _soup_rays(cuda, seed=3)
    N, T = ro.shape[0], feat.shape[0]
    r = np.random.default_rng(4)
    args = (feat, center, ro, rd, torch.full((N,), 1e-4, device=cuda),
            torch.full((N,), 1e30, device=cuda), ex)
    carry = (torch.from_numpy(r.uniform(-1.0, 9.0, N).astype(np.float32))
             .to(cuda),
             torch.from_numpy(r.integers(-1, T, N).astype(np.int32))
             .to(cuda))
    t_all, i_all = rk.closest_hit(*args, table=table)
    tr, ir = rk._closest_ref(*args)
    assert (i_all == ir).float().mean().item() >= 0.999
    for share in (0.3, 0.0, 1.0):
        need = torch.from_numpy(r.random(N) < share).to(cuda)
        before = rk.LAUNCHES["closest"]
        t, i = rk.closest_hit(*args, need, carry, table=table)
        assert rk.LAUNCHES["closest"] == before + 1
        bits = t.view(torch.int32)
        assert torch.equal(bits[need], t_all.view(torch.int32)[need])
        assert torch.equal(i[need], i_all[need])
        assert torch.equal(bits[~need], carry[0].view(torch.int32)[~need])
        assert torch.equal(i[~need], carry[1][~need])


@pytest.mark.gpu
@pytest.mark.parametrize("smaller_left", [False, True])
def test_closest_hit_ties_on_card(cuda, smaller_left):
    """Coincident triangles at the same t in different tiles: the kernel
    returns the smaller bake id, as its plain version does."""
    p0, e1, e2, left, right = [x.to(cuda) if torch.is_tensor(x) else x
                               for x in tie_soup(smaller_left)]
    center = torch.zeros(3, device=cuda)
    feat = rk.tri_features(p0, e1, e2, center)
    table = rk.ray_table(p0, e1, e2, center, feat,
                         rk.tile_order(p0, e1, e2))
    ro, rd = (x.to(cuda) for x in tie_rays(2048))
    N = ro.shape[0]
    t, tri = rk.closest_hit(feat, center, ro, rd,
                            torch.full((N,), 1e-4, device=cuda),
                            torch.full((N,), 1e30, device=cuda),
                            torch.full((N, 3), -1, dtype=torch.int32,
                                       device=cuda), table=table)
    assert (tri == min(left, right)).all().item()
    assert (t == 3.0).all().item()


@pytest.mark.gpu
@pytest.mark.parametrize("fsd", [False, True])
def test_carried_hits_on_card(cuda, fsd):
    """A render whose pool carries hits (lanes refill and hit the depth
    cap) and one that traces every lane: every counter equal, the image
    within splat-order rounding."""
    import functools

    from wave_tracer_tpu_torch.integrator import path_compact
    from wave_tracer_tpu_torch.render import renderer as renderer_mod
    scene = make_box_scene(res=16, spp=4)
    scene.integrator.fsd = fsd
    scene.integrator.max_depth = 5
    built = build_scene(scene, device=cuda)
    img, st = render_scene(built, device="cuda", pool_lanes=256)
    pool = renderer_mod.render_pool
    renderer_mod.render_pool = functools.partial(path_compact.render_pool,
                                                 carry_hits=False)
    try:
        img0, st0 = render_scene(built, device="cuda", pool_lanes=256)
    finally:
        renderer_mod.render_pool = pool
    assert st["device_counters"] == st0["device_counters"]
    np.testing.assert_allclose(img, img0, rtol=1e-5, atol=1e-12)


@pytest.mark.gpu
def test_anyhit_at_the_forward_layout(cuda):
    """K2 on the calls of a forward render of the coverage scene (one
    batch of 1,024 lanes: 51·N segments per call, three exclusions, the
    live-lane need mask) against its plain version on the same
    arguments: needed rows agree on >= 99.9%, unneeded rows are False."""
    from wave_tracer_tpu_torch.scene.procedural import make_coverage_scene
    built = build_scene(make_coverage_scene(16), device=cuda)
    real, calls = rk.any_hit, []

    def spy(*args, **kw):
        need = args[7] if len(args) > 7 else kw["need"]
        calls.append(([a.clone() for a in args[:7]], need.clone(),
                      kw["table"]))
        return real(*args, **kw)

    rk.any_hit = spy
    try:
        img, st = render_scene(built, spp=4, device="cuda", pool_lanes=1024)
    finally:
        rk.any_hit = real
    assert st["mode"] == "forward-wave" and np.isfinite(img).all()
    assert len(calls) == 4 and sum(int(c[1].sum()) for c in calls) > 0
    for args, need, table in calls:
        assert args[2].shape[0] == 51 * 1024
        ok = rk.any_hit(*args, need, table=table)
        ref = rk._anyhit_ref(*args, need)
        assert not ok[~need].any().item()
        if need.any():
            assert (ok[need] == ref[need]).float().mean().item() >= 0.999
