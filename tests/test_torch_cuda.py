"""K1/K2/K3, K4/K5 (the BVH route, and its small trees below 2^17
triangles), the brute route, the classical, wave, coverage, city
and materials-box renders, the
mask and the CLI on a CUDA card against the plain torch versions. Marked `gpu`: each test skips without a
card. This file imports no
jax, so it also runs on GPU hosts without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from test_torch_threads import cap_torch_threads
from wave_tracer_tpu_torch.accel import cone_kernels as ck
from wave_tracer_tpu_torch.accel import ray_kernels as rk
from wave_tracer_tpu_torch.integrator.traversal import segment_boundaries
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.scene import build_scene
from wave_tracer_tpu_torch.scene.procedural import make_box_scene
from test_torch_cull import tie_rays, tie_soup

cap_torch_threads()


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
    256-lane block and not, with and without the triangle-range split, and
    on a soup of duplicated triangles (exact ties); test_mxu_cone.py's
    bars."""
    r = np.random.default_rng(7)
    for T, N in ((700, 256), (3000, 4100), (12, 20000), (1400, 4100)):
        p0 = r.uniform(-4, 4, (T, 3)).astype(np.float32)
        e = r.uniform(-1, 1, (2, T, 3)).astype(np.float32)
        if T == 1400:
            # every triangle twice: the winners break exact ties by id
            p0[700:], e[:, 700:] = p0[:700], e[:, :700]
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
    before = dict(ck.LAUNCHES)
    zc, cnt = ck.cone_minz(*args, table=table)
    zr, cr = ck._minz_ref(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cone_minz"] == before["cone_minz"] + 1
    assert torch.isfinite(zr).any().item()
    assert torch.equal(zc, zr) and torch.equal(cnt, cr)
    stats = torch.zeros((4,), dtype=torch.int64, device=zc.device)
    zs, cs = ck.cone_minz(*args, table=table, stats=stats)
    assert torch.equal(zs, zc) and torch.equal(cs, cnt)
    tested, entered, witer, witer_in = stats.tolist()
    assert entered <= tested <= args[1].shape[0] * args[0].shape[0]
    assert witer_in <= witer and entered >= int(cnt.sum())
    # the winner build: the same minima and counts, and each minimum's
    # triangle as the twin picks it (least z, then least id)
    zw, cw, win = ck.cone_minz(*args, table=table, winners=True)
    _, _, win_r = ck._minz_ref(*args, winners=True)
    assert ck.LAUNCHES["cone_minz"] == before["cone_minz"] + 3
    assert ck.LAUNCHES["cone_minz_winners"] \
        == before["cone_minz_winners"] + 1
    assert torch.equal(zw, zc) and torch.equal(cw, cnt)
    assert torch.equal(win, win_r)
    assert torch.equal(win >= 0, torch.isfinite(zc))


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


@pytest.mark.gpu
@pytest.mark.parametrize("integrator", ["plt_path", "plt_bdpt"])
def test_kernels_on_the_materials_box_calls(cuda, integrator):
    """Every K1, K2 and K3 call of a render of the materials box (32×32,
    2 spp, FSD on: the wave path, or polarimetric bdpt) against its plain
    version on the same inputs: K1's ids agree on >= 99.9% of the needed
    rows, t within rtol 1e-4 / atol 1e-5 where they agree, the other rows
    hold their carried hit bit for bit; K2's needed rows agree on >= 99.9%
    and the others are False; K3's minima and counts are bit-equal. The
    card's image is finite and, under bdpt, every Stokes vector physical."""
    from wave_tracer_tpu_torch.scene.procedural import \
        make_materials_box_scene
    scene = make_materials_box_scene(res=32, spp=2)
    scene.integrator.type = integrator
    scene.integrator.max_depth = 5
    scene.sensors[0].polarimetric = integrator == "plt_bdpt"
    built = build_scene(scene, device=cuda)
    calls = {"closest": [], "anyhit": [], "cone_minz": []}
    real = {"closest": rk.closest_hit, "anyhit": rk.any_hit,
            "cone_minz": ck.cone_minz}

    def copy(x):
        if torch.is_tensor(x):
            return x.clone()
        return tuple(copy(y) for y in x) if isinstance(x, tuple) else x

    def spy(kind):
        def wrapper(*args, **kw):
            out = real[kind](*args, **kw)
            calls[kind].append((copy(args), copy(out)))
            return out
        return wrapper

    rk.closest_hit, rk.any_hit = spy("closest"), spy("anyhit")
    ck.cone_minz = spy("cone_minz")
    try:
        img, st = render_scene(built, device="cuda", pool_lanes=1024)
    finally:
        rk.closest_hit, rk.any_hit = real["closest"], real["anyhit"]
        ck.cone_minz = real["cone_minz"]
    assert np.isfinite(img).all() and img.mean() > 0
    if integrator == "plt_bdpt":
        s = img.reshape(32, 32, 3, 4)
        assert (np.linalg.norm(s[..., 1:], axis=-1)
                <= s[..., 0] * (1 + 1e-5) + 1e-6 * s[..., 0].max()).all()
    assert calls["closest"] and calls["anyhit"]
    assert bool(calls["cone_minz"]) == (integrator == "plt_path")
    for args, (t_k, i_k) in calls["closest"]:
        need, carry = args[7], args[8]
        t_r, i_r = rk._closest_ref(*args[:7], need, carry)
        rows = torch.ones_like(i_k, dtype=torch.bool) if need is None \
            else need
        if rows.any():
            assert (i_k == i_r)[rows].float().mean().item() >= 0.999
        both = rows & (i_k == i_r) & (i_r >= 0)
        torch.testing.assert_close(t_k[both], t_r[both], rtol=1e-4,
                                   atol=1e-5)
        if need is not None and carry is not None:
            assert torch.equal(t_k[~need], carry[0][~need])
            assert torch.equal(i_k[~need], carry[1][~need])
    for args, occ in calls["anyhit"]:
        need = args[7] if len(args) > 7 else None
        ref = rk._anyhit_ref(*args[:7], need)
        rows = torch.ones_like(ref) if need is None else need
        if rows.any():
            assert (occ == ref)[rows].float().mean().item() >= 0.999
        if need is not None:
            assert not occ[~need].any().item()
    for args, (zc, cnt) in calls["cone_minz"]:
        zr, cr = ck._minz_ref(*args)
        assert torch.equal(zc, zr) and torch.equal(cnt, cr)


def _primal_spy(monkeypatch):
    """Wrap the three launchers: record every tensor they receive and fail
    on one that requires grad, carries a tangent or is wrapped by a
    torch.func transform. Returns the launch counts seen."""
    import torch.autograd.forward_ad as fwAD
    seen = {"closest": 0, "anyhit": 0, "cone": 0}
    fnc = torch._C._functorch

    def wrap(mod, name, key):
        inner = getattr(mod, name)

        def spy(*args, **kw):
            for x in list(args) + list(kw.values()):
                for y in (x if isinstance(x, tuple) else (x,)):
                    if isinstance(y, torch.Tensor):
                        assert not y.requires_grad
                        assert not fnc.is_functorch_wrapped_tensor(y)
                        assert fwAD.unpack_dual(y).tangent is None
            seen[key] += 1
            return inner(*args, **kw)
        monkeypatch.setattr(mod, name, spy)

    wrap(rk, "_launch_closest", "closest")
    wrap(rk, "_launch_anyhit", "anyhit")
    wrap(ck, "_launch", "cone")
    return seen


def _grad_lanes(res, dev):
    pix = torch.arange(res * res, device=dev)
    return (torch.stack([pix % res, pix // res], -1),
            torch.full((res * res, 2), 0.5, device=dev),
            torch.zeros(res * res, dtype=torch.int64, device=dev))


def _scaled_params(data, p):
    """data with spectra row i scaled by p[i] and, where p is longer, the
    complex-IOR row's n and κ by p[S] and p[S + 1]."""
    import dataclasses
    st = data.tables.spectra
    S = st.vals.shape[0]
    tables = dataclasses.replace(data.tables, spectra=dataclasses.replace(
        st, vals=st.vals * p[:S, None]))
    if p.shape[0] > S:
        cs = tables.cspectra
        tables = dataclasses.replace(tables, cspectra=dataclasses.replace(
            cs, n=cs.n * p[S], kappa=cs.kappa * p[S + 1]))
    return dataclasses.replace(data, tables=tables)


def _slit_shift(data, theta):
    """The slit screen's three strips moved along x by θ (triangles and
    edges, through dataclasses.replace)."""
    import dataclasses
    geo, ed = data.geo, data.edges
    xhat = torch.tensor([1.0, 0.0, 0.0], device=geo.p0.device)
    d = theta * xhat
    geo = dataclasses.replace(
        geo, p0=geo.p0 + d,
        tri_geom=geo.tri_geom + torch.nn.functional.pad(d, (0, 9)))
    ed = dataclasses.replace(ed, p0=ed.p0 + d, p1=ed.p1 + d,
                             center=ed.center + d)
    return dataclasses.replace(data, geo=geo, edges=ed)


def _film_of(path, out, sensor):
    """The developed film of one bdpt or forward batch."""
    from wave_tracer_tpu_torch.sensor import film as film_mod
    values = out[1]
    film = film_mod.make_film(sensor.width, sensor.height, values.shape[-1],
                              sensor.rfilter_sigma, device=values.device)
    if path == "bdpt":
        pos, _, ok, (lp, lv, lo) = out
        film_mod.splat(film, pos, values, ok)
        film_mod.splat_direct(film, lp, lv, lo)
    else:
        pos, _, ok, sig, (npos, nval, nok) = out
        film_mod.splat_direct_gaussian(film, pos, sig, values, ok)
        if path == "forward_utd":
            film_mod.splat_direct(film, npos, nval, nok)
    return film_mod.develop(film, 1.0)


def _path_image_fn(path, dev, tmp_path):
    """(f(p): the path's image at 16x16 over parameter scales p, len(p),
    f_geo(θ): the slit map's image over a screen shift, or None)."""
    from wave_tracer_tpu_torch.integrator.plt_bdpt import trace_bdpt
    from wave_tracer_tpu_torch.integrator.plt_path_forward import \
        trace_forward
    from wave_tracer_tpu_torch.scene.procedural import (make_coverage_scene,
                                                        slit_screen_xml)
    from wave_tracer_tpu_torch.scene.xml import load_scene_xml
    if path == "bdpt":
        scene = make_box_scene(res=16, spp=4)
        built = build_scene(scene, device=dev)
        pix = torch.arange(256, device=dev).repeat(4)
        sids = torch.arange(4, device=dev).repeat_interleave(256)
        pxy = torch.stack([pix % 16, pix // 16], -1)
        jit = torch.full((1024, 2), 0.5, device=dev)

        def run(data):
            return trace_bdpt(data, pxy, jit, 3, sids, sensor=scene.sensors[0],
                              max_depth=4, eps=1e-4, fsd=True)
        P = built.data.tables.spectra.vals.shape[0]
    else:
        if path == "forward_utd":
            scene = make_coverage_scene(16)
        else:
            xml = tmp_path / "slits.xml"
            xml.write_text(slit_screen_xml(16, 1, 4))
            scene = load_scene_xml(str(xml))
        built = build_scene(scene, device=dev)
        ids = torch.arange(1024, dtype=torch.int32, device=dev)
        mode = "utd" if path == "forward_utd" else "fraunhofer"

        def run(data):
            return trace_forward(data, ids, 3, torch.zeros_like(ids),
                                 sensor=scene.sensors[0],
                                 edge_table=data.edges, max_depth=4,
                                 eps=1e-4 if mode == "utd" else 1e-5,
                                 fsd_mode=mode)
        P = built.data.tables.spectra.vals.shape[0] \
            + (2 if mode == "utd" else 0)
    data, sensor = built.data, scene.sensors[0]

    def f(p):
        return _film_of(path, run(_scaled_params(data, p)), sensor)

    def f_geo(theta):
        return _film_of(path, run(_slit_shift(data, theta)), sensor)
    return f, P, (f_geo if path == "forward_fraunhofer" else None)


def _share_close(a, b, rtol, atol_frac):
    scale = max(float(np.abs(b).max()), 1e-30)
    return float(np.isclose(a, b, rtol=rtol, atol=atol_frac * scale)
                 .all(-1).mean())


@pytest.mark.gpu
@pytest.mark.parametrize("wave", [False, True, "bdpt", "forward_utd",
                                  "forward_fraunhofer"])
def test_gradients_on_card_match_cpu(cuda, monkeypatch, tmp_path, wave):
    """Both AD modes through K1/K2 (and K3 on the wave path) on the card,
    for the classical (False) and wave (True) plt_path, plt_bdpt (FSD on)
    and forward transport (UTD on the coverage scene, Fraunhofer on the
    slit screen): no launcher sees a tensor with a derivative, reverse
    mode agrees with forward mode row by row, and the image and pixel
    maps agree with the plain versions on the CPU: the classical and
    wave image bars of PERF.md §2 (the wave bars also for bdpt, with the
    means within 2%); forward UTD, FSD-NEE splats included, on >= 94% of
    the pixels within rtol 0.12, atol 0.02·max; the slit screen, and its
    map w.r.t. a translation of the screen, on >= 90% within rtol 0.15,
    atol 0.03·max."""
    import dataclasses

    import torch.autograd.forward_ad as fwAD

    from wave_tracer_tpu_torch.integrator.path import trace_paths
    from wave_tracer_tpu_torch.integrator.plt_path import trace_paths_wave
    scene = make_box_scene(res=16, spp=1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f_geo = None
        if isinstance(wave, str):
            f, S, f_geo = _path_image_fn(wave, dev, tmp_path)
        else:
            data = build_scene(scene, device=dev).data
            pxy, jit, sids = _grad_lanes(16, dev)
            vals = data.tables.spectra.vals
            S = vals.shape[0]

            def f(rs):
                d = dataclasses.replace(data, tables=dataclasses.replace(
                    data.tables, spectra=dataclasses.replace(
                        data.tables.spectra, vals=vals * rs[:, None])))
                if wave:
                    return trace_paths_wave(d, pxy, jit, 3, sids,
                                            sensor=scene.sensors[0],
                                            edge_table=d.edges, max_depth=3,
                                            eps=1e-4)[1]
                return trace_paths(d, pxy, jit, 3, sids,
                                   sensor=scene.sensors[0], max_depth=3,
                                   eps=1e-4)[1]

        with monkeypatch.context() as m:
            seen = _primal_spy(m) if dev.type == "cuda" else None
            ones = torch.ones(S, device=dev)
            with fwAD.dual_level():
                img, g = fwAD.unpack_dual(f(fwAD.make_dual(ones, ones)))
            rs = torch.ones(S, device=dev, requires_grad=True)
            f(rs).mean().backward()
            _, g_func = torch.func.jvp(f, (ones,), (ones,))
            # the reverse-mode gradient of the mean, row by row, is the
            # mean of the forward-mode map along that row
            for r in range(S):
                with fwAD.dual_level():
                    _, gr = fwAD.unpack_dual(f(fwAD.make_dual(
                        ones, torch.eye(S, device=dev)[r])))
                torch.testing.assert_close(gr.mean(), rs.grad[r],
                                           rtol=1e-4, atol=1e-14)
            if f_geo is not None:
                zero_t = torch.zeros((), device=dev)
                with fwAD.dual_level():
                    _, g_geo = fwAD.unpack_dual(f_geo(fwAD.make_dual(
                        zero_t, torch.ones((), device=dev))))
        if seen is not None:
            assert seen["closest"] > 0
            assert seen["anyhit"] > 0 or wave == "forward_fraunhofer"
            assert (seen["cone"] > 0) == (wave is True)
        torch.testing.assert_close(g_func, g, rtol=1e-5, atol=1e-14)
        out[dev.type] = (img.cpu().numpy(), g.cpu().numpy()) + (
            (g_geo.cpu().numpy(),) if f_geo is not None else ())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.isfinite(a).all() and (a != 0).any()
        scale = np.maximum(np.abs(b), np.abs(b).mean())
        if wave == "forward_utd":
            assert _share_close(a, b, 0.12, 0.02) >= 0.94
        elif wave == "forward_fraunhofer":
            assert _share_close(a, b, 0.15, 0.03) >= 0.90
        elif wave:
            if wave == "bdpt":
                np.testing.assert_allclose(a.mean((0, 1)), b.mean((0, 1)),
                                           rtol=0.02)
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.999
            assert (np.abs(a - b) <= 1e-2 * scale).all(-1).mean() >= 0.90
        else:
            assert (np.abs(a - b) <= 1e-3 * scale).all(-1).mean() >= 0.98


@pytest.mark.gpu
def test_wall_translation_on_card(cuda, monkeypatch):
    """The hit distance's derivative on the card: a back-wall translation's
    pixel map against the plain version, and t bit for bit without it."""
    import dataclasses

    import torch.autograd.forward_ad as fwAD

    from wave_tracer_tpu_torch.accel import trace as ttrace
    from wave_tracer_tpu_torch.integrator.path import trace_paths
    scene = make_box_scene(res=16, spp=1)
    scene.integrator.fsd = False
    out = {}
    for dev in (cuda, torch.device("cpu")):
        data = build_scene(scene, device=dev).data
        pxy, jit, sids = _grad_lanes(16, dev)
        wall = (data.geo.tri_attr[:, 22] == 2).float()[:, None]

        def f(th):
            d3 = wall * (th * torch.tensor([0.0, 0.0, 1.0], device=dev))
            geo = dataclasses.replace(
                data.geo, p0=data.geo.p0 + d3,
                tri_geom=data.geo.tri_geom
                + torch.nn.functional.pad(d3, (0, 9)))
            return trace_paths(dataclasses.replace(data, geo=geo), pxy, jit,
                               7, sids, sensor=scene.sensors[0], max_depth=2,
                               eps=1e-4)[1]

        with monkeypatch.context() as m:
            seen = _primal_spy(m) if dev.type == "cuda" else None
            with fwAD.dual_level():
                img, g = fwAD.unpack_dual(f(fwAD.make_dual(
                    torch.tensor(0.0, device=dev),
                    torch.tensor(1.0, device=dev))))
        if seen is not None:
            assert seen["closest"] > 0
        out[dev.type] = g.cpu().numpy()
        ro, rd, _ = scene.sensors[0].generate_rays(pxy, jit)
        args = (ro, rd, torch.full((256,), 1e-4, device=dev),
                torch.full((256,), 1e30, device=dev))
        t0 = ttrace.trace(data.geo, *args)[0]
        rog = ro.clone().requires_grad_()
        assert torch.equal(ttrace.trace(data.geo, rog, *args[1:])[0]
                           .detach(), t0)
    a, b = out["cuda"], out["cpu"]
    assert np.isfinite(a).all() and (a != 0).any()
    scale = np.maximum(np.abs(b), np.abs(b).mean())
    assert (np.abs(a - b) <= 1e-3 * scale).all(-1).mean() >= 0.98


@pytest.mark.gpu
def test_mask_and_cli_render_on_card(cuda, tmp_path):
    """render_mask on the card equals the CPU's; the CLI's render of the
    box file on the card agrees with its render on the CPU at the wave
    bars (PERF.md §2)."""
    from wave_tracer_tpu_torch import cli
    from wave_tracer_tpu_torch.render.mask import render_mask
    from wave_tracer_tpu_torch.render.output import read_exr
    from wave_tracer_tpu_torch.scene.procedural import box_scene_xml
    from wave_tracer_tpu_torch.scene.xml import load_scene_xml

    path = tmp_path / "box.xml"
    path.write_text(box_scene_xml(32, 4, 5, True))
    built = build_scene(load_scene_xml(str(path)), device=cuda)
    sensor = built.scene.sensors[0]
    before = rk.LAUNCHES["closest"]
    m_card = render_mask(built, sensor)
    assert rk.LAUNCHES["closest"] > before
    np.testing.assert_array_equal(m_card, render_mask(built.on("cpu"),
                                                      sensor))
    img = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        assert cli.main(["render", str(path), "--device", dev, "-o",
                         str(out), "--mask"]) == 0
        x, names = read_exr(str(out / "camera.exr"))
        img[dev] = np.stack([x[..., names.index(c)] for c in "RGB"], -1)
    a, b = img["cuda"], img["cpu"]
    np.testing.assert_allclose(a.mean((0, 1)), b.mean((0, 1)), rtol=0.02)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(b), np.abs(b).mean())
    assert (np.abs(a - b) <= 1e-2 * scale).all(-1).mean() >= 0.90


def _card_rank(rank, world, init, out):
    from wave_tracer_tpu_torch.parallel import launch
    from wave_tracer_tpu_torch.parallel.dist import render_distributed
    launch.initialize_distributed(init, world, rank, backend="gloo",
                                  device="cuda", timeout_s=120.0)
    try:
        scene = make_box_scene(res=32, spp=2)
        scene.integrator.fsd = True
        scene.integrator.max_depth = 4
        before = dict(rk.LAUNCHES, **ck.LAUNCHES)
        img, st = render_distributed(build_scene(scene, device="cuda"),
                                     lanes_per_device=512)
        assert st["processes"] == world and st["mode"] == "wave-dist"
        after = dict(rk.LAUNCHES, **ck.LAUNCHES)
        assert all(after[k] > before[k]
                   for k in ("closest", "anyhit", "cone_minz")), (before, after)
        assert after["cone_minz_winners"] == before["cone_minz_winners"]
        np.save(f"{out}/img_{rank}.npy", img)
    finally:
        launch.shutdown()


@pytest.mark.gpu
def test_two_rank_gloo_film_on_card(cuda, tmp_path):
    """Two ranks of a gloo group on the one card (NCCL refuses two ranks
    on one device) render the wave box through K1/K2/K3 and merge their
    films; each rank's image is one rank's within 1e-5·max."""
    from test_torch_parallel import spawn_ranks
    from wave_tracer_tpu_torch.parallel.dist import render_distributed
    spawn_ranks(_card_rank, 2, f"file://{tmp_path / 'rdv'}", str(tmp_path),
                deadline_s=300.0)
    scene = make_box_scene(res=32, spp=2)
    scene.integrator.fsd = True
    scene.integrator.max_depth = 4
    ref, _ = render_distributed(build_scene(scene, device=cuda),
                                lanes_per_device=1024, device=cuda)
    for rank in (0, 1):
        img = np.load(tmp_path / f"img_{rank}.npy")
        np.testing.assert_allclose(img, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def _bvh_box(monkeypatch, dev, tessellation=48, res=16, spp=2):
    """The box with bench.py's sphere at `tessellation`, MXU_MAX_TRIS
    lowered below its triangle count: baked for the BVH route."""
    from wave_tracer_tpu_torch.accel import trace as trace_mod
    monkeypatch.setattr(trace_mod, "MXU_MAX_TRIS", 1024)
    scene = make_box_scene(res=res, spp=spp, icosphere=True,
                           tessellation=tessellation)
    built = build_scene(scene, device=dev)
    assert built.data.geo.node_pack is not None
    return built


@pytest.mark.gpu
def test_bvh_kernels_match_twins(cuda, monkeypatch):
    """K4 and K5 against their twins on the same card tensors, words bit
    for bit: rays from inside the scene's bounds, a third excluding their
    first hit; K4 with a need mask and carried hits, K5 with one to three
    exclusions and a need mask."""
    from wave_tracer_tpu_torch.accel import bvh_kernels as bk
    geo = _bvh_box(monkeypatch, cuda).data.geo
    nodes, tris = geo.node_pack, geo.tri_geom
    r = np.random.default_rng(4)
    N = 8192
    lo = geo.p0.min(0).values.cpu().numpy() - 0.2
    hi = geo.p0.max(0).values.cpu().numpy() + 0.2
    ro = torch.from_numpy(r.uniform(lo, hi, (N, 3)).astype(np.float32))
    rd = torch.from_numpy(r.normal(size=(N, 3)).astype(np.float32))
    ro, rd = ro.to(cuda), (rd / rd.norm(dim=-1, keepdim=True)).to(cuda)
    tmin = torch.full((N,), 1e-4, device=cuda)
    for tmax_v in (1e30, 1.5):
        tmax = torch.full((N,), tmax_v, device=cuda)
        none = torch.full((N,), -1, dtype=torch.int32, device=cuda)
        _, first = bk.closest_hit(nodes, tris, ro, rd, tmin, tmax, none)
        some = torch.from_numpy(r.random(N) < 1 / 3).to(cuda)
        ex = torch.where(some, first, -1).to(torch.int32)
        args = (nodes, tris, ro, rd, tmin, tmax, ex)
        t_k, i_k = bk.closest_hit(*args)
        t_r, i_r = bk._closest_ref(*args)
        assert torch.equal(i_k, i_r)
        assert torch.equal(t_k.view(torch.int32), t_r.view(torch.int32))
        need = torch.from_numpy(r.random(N) < 0.5).to(cuda)
        carry = (torch.full((N,), 2.0, device=cuda),
                 torch.full((N,), 3, dtype=torch.int32, device=cuda))
        t_n, i_n = bk.closest_hit(*args, need, carry)
        assert torch.equal(i_n[need], i_k[need])
        assert (i_n[~need] == 3).all() and (t_n[~need] == 2.0).all()
        ex3 = torch.from_numpy(np.where(
            r.random((N, 3)) < 0.4, r.integers(0, geo.num_tris, (N, 3)),
            -1).astype(np.int32)).to(cuda)
        ex3[:, 0] = ex
        a5 = (nodes, tris, ro, rd, tmin, tmax, ex3)
        o_k = bk.any_hit(*a5)
        assert torch.equal(o_k, bk._anyhit_ref(*a5))
        o_n = bk.any_hit(*a5, need)
        assert torch.equal(o_n[need], o_k[need]) and not o_n[~need].any()


SMALL_TREES = ("leaf_root", "single_split", "box_icosphere")


def small_tree(case):
    """(positions in the tree's leaf order (T, 3, 3), FlatBVH) of a small
    BVH: a root that is a leaf (3 triangles), one split (8 triangles in
    two far clusters: a root and two leaves), and the box with bench.py's
    sphere at 1,280 triangles (1,292)."""
    from wave_tracer_tpu_torch.accel import bvh
    r = np.random.default_rng(SMALL_TREES.index(case))
    if case == "box_icosphere":
        scene = make_box_scene(res=8, spp=1, icosphere=True, tessellation=24)
        pos = np.concatenate([s.soup.positions for s in scene.shapes])
    else:
        T = 3 if case == "leaf_root" else 8
        pos = r.normal(size=(T, 3, 3)) * 0.3
        pos[:, :, 0] += np.where(np.arange(T) < T // 2, -2.0, 2.0)[:, None]
        pos = pos.astype(np.float32)
    tree = bvh.build_bvh(pos)
    return pos[tree.tri_order], tree


def small_tree_tables(case, dev):
    """(node_pack, tri_geom) on `dev`, and the positions, of small_tree."""
    from wave_tracer_tpu_torch.accel import bvh
    pos, tree = small_tree(case)
    tri_geom = np.zeros((len(pos), 12), np.float32)
    tri_geom[:, 0:3] = pos[:, 0]
    tri_geom[:, 3:6] = pos[:, 1] - pos[:, 0]
    tri_geom[:, 6:9] = pos[:, 2] - pos[:, 0]
    return (torch.from_numpy(bvh.pack_nodes(tree)).to(dev),
            torch.from_numpy(tri_geom).to(dev), pos)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SMALL_TREES)
def test_bvh_kernels_on_small_trees(cuda, case):
    """K4 and K5 against their twins, words bit for bit, on trees below
    2^17 triangles (WT_TRACE_BACKEND=bvh takes K4/K5 from 2,049
    triangles, and any tree a bridged JAX bake brings): rays from around
    the triangles' bounds, a third excluding their first hit, K5 with up
    to three exclusions; both with a need mask, K4 with carried hits."""
    from wave_tracer_tpu_torch.accel import bvh_kernels as bk
    nodes, tris, pos = small_tree_tables(case, cuda)
    assert (len(nodes) == 1) == (case == "leaf_root")
    assert len(nodes) == 3 or case != "single_split"
    r = np.random.default_rng(7)
    N = 8192
    lo, hi = pos.min((0, 1)) - 0.5, pos.max((0, 1)) + 0.5
    ro = torch.from_numpy(r.uniform(lo, hi, (N, 3)).astype(np.float32))
    rd = torch.from_numpy(r.normal(size=(N, 3)).astype(np.float32))
    ro, rd = ro.to(cuda), (rd / rd.norm(dim=-1, keepdim=True)).to(cuda)
    tmin = torch.full((N,), 1e-4, device=cuda)
    tmax = torch.full((N,), 1e30, device=cuda)
    none = torch.full((N,), -1, dtype=torch.int32, device=cuda)
    _, first = bk.closest_hit(nodes, tris, ro, rd, tmin, tmax, none)
    assert (first >= 0).any().item()
    some = torch.from_numpy(r.random(N) < 1 / 3).to(cuda)
    ex = torch.where(some, first, -1).to(torch.int32)
    args = (nodes, tris, ro, rd, tmin, tmax, ex)
    t_k, i_k = bk.closest_hit(*args)
    t_r, i_r = bk._closest_ref(*args)
    assert torch.equal(i_k, i_r)
    assert torch.equal(t_k.view(torch.int32), t_r.view(torch.int32))
    need = torch.from_numpy(r.random(N) < 0.5).to(cuda)
    carry = (torch.full((N,), 2.0, device=cuda),
             torch.full((N,), 1, dtype=torch.int32, device=cuda))
    t_n, i_n = bk.closest_hit(*args, need, carry)
    assert torch.equal(i_n[need], i_k[need])
    assert (i_n[~need] == 1).all() and (t_n[~need] == 2.0).all()
    ex3 = torch.from_numpy(np.where(
        r.random((N, 3)) < 0.4, r.integers(0, len(pos), (N, 3)),
        -1).astype(np.int32)).to(cuda)
    ex3[:, 0] = ex
    a5 = (nodes, tris, ro, rd, tmin, torch.full((N,), 2.0, device=cuda), ex3)
    o_k = bk.any_hit(*a5)
    assert torch.equal(o_k, bk._anyhit_ref(*a5))
    o_n = bk.any_hit(*a5, need)
    assert torch.equal(o_n[need], o_k[need]) and not o_n[~need].any()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [None, 97], ids=["one_slice", "sliced"])
def test_brute_route_on_card(cuda, monkeypatch, rows):
    """The brute route (WT_TRACE_BACKEND=brute) on the card: trace and
    occluded with need/carry make no host sync and launch no kernel of
    the port; hits and occlusion equal the CPU's, t bit for bit, u and v
    within 1e-6 (a fused multiply-add may round a cross product of the
    carried rows' solve once where the CPU rounds twice). `rows`: the
    card's row slices cut to 97 rows (43 slices) as well."""
    from wave_tracer_tpu_torch.accel import bvh_kernels as bk
    from wave_tracer_tpu_torch.accel import trace as trace_mod
    monkeypatch.setenv("WT_TRACE_BACKEND", "brute")
    if rows is not None:
        monkeypatch.setattr(trace_mod, "_CONE_PAIRS",
                            dict(trace_mod._CONE_PAIRS, cuda=12 * rows))
    geo = build_scene(make_box_scene(res=8, spp=1), device=cuda).data.geo
    r = np.random.default_rng(8)
    N = 4096
    ro = torch.from_numpy(r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32))
    ro[:, 1] += 1.0
    rd = torch.from_numpy(r.normal(size=(N, 3)).astype(np.float32))
    rd = rd / rd.norm(dim=-1, keepdim=True)
    tmin, tmax = torch.full((N,), 1e-4), torch.full((N,), 1.5)
    need = torch.from_numpy(r.random(N) < 0.5)
    carry = (torch.full((N,), 0.5), torch.full((N,), 3, dtype=torch.int32))
    cpu = [x.to(cuda) for x in (ro, rd, tmin, tmax, need, *carry)]
    for counts in (rk.LAUNCHES, ck.LAUNCHES, bk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = trace_mod.trace(geo, *cpu[:4], need=cpu[4],
                              carry=(cpu[5], cpu[6]))
        occ = trace_mod.occluded(geo, *cpu[:4], need=cpu[4])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(v == 0 for c in (rk.LAUNCHES, bk.LAUNCHES) for v in c.values())
    hgeo = build_scene(make_box_scene(res=8, spp=1), device="cpu").data.geo
    want = trace_mod.trace(hgeo, ro, rd, tmin, tmax, need=need, carry=carry)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6)
    assert torch.equal(occ.cpu(),
                       trace_mod.occluded(hgeo, ro, rd, tmin, tmax,
                                          need=need))
    assert (want[1][need] >= 0).float().mean() > 0.5


@pytest.mark.gpu
def test_bvh_route_render_on_card(cuda, monkeypatch):
    """The wave box with bench.py's sphere at 1,280 triangles on the BVH
    route (MXU_MAX_TRIS lowered), card against CPU at the wave bars; the
    card's render launches K4, K5 and K3 and neither K1 nor K2."""
    from wave_tracer_tpu_torch.accel import bvh_kernels as bk
    built = _bvh_box(monkeypatch, cuda, tessellation=24)
    built.scene.integrator.fsd = True
    built.scene.integrator.max_depth = 4
    for counts in (rk.LAUNCHES, ck.LAUNCHES, bk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    img_c, st_c = render_scene(built, device="cuda")
    assert bk.LAUNCHES["bvh_closest"] > 0 and bk.LAUNCHES["bvh_any"] > 0
    assert ck.LAUNCHES["cone_minz"] > 0
    assert rk.LAUNCHES["closest"] == 0 and rk.LAUNCHES["anyhit"] == 0
    img_h, st_h = render_scene(built, device="cpu")
    assert st_c["mode"] == st_h["mode"] == "wave-compact"
    np.testing.assert_allclose(img_c.mean((0, 1)), img_h.mean((0, 1)),
                               rtol=0.02)
    assert np.corrcoef(img_c.ravel(), img_h.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(img_h), np.abs(img_h).mean())
    assert (np.abs(img_c - img_h) <= 1e-2 * scale).all(-1).mean() >= 0.90


@pytest.mark.gpu
def test_city_coverage_on_card(cuda):
    """The city coverage map (more than 2048 wedge edges: the clustered
    sweep) at 16x16 x 4, card against CPU at the coverage film bars."""
    from wave_tracer_tpu_torch.scene.procedural import \
        make_city_coverage_scene
    built = build_scene(make_city_coverage_scene(16), device=cuda)
    assert built.data.edges.count > 2048
    img_c, st_c = render_scene(built, spp=4, device="cuda", pool_lanes=1024)
    img_h, _ = render_scene(built, spp=4, device="cpu", pool_lanes=1024)
    assert st_c["mode"] == "forward-wave"
    a, b = img_c[..., 0], img_h[..., 0]
    both = (a > 0) & (b > 0)
    assert abs(np.median(a[both] / b[both]) - 1.0) <= 1e-3
    la = 10 * np.log10(np.maximum(a, 1e-30))
    lb = 10 * np.log10(np.maximum(b, 1e-30))
    assert np.corrcoef(la.ravel(), lb.ravel())[0, 1] >= 0.95
    assert (np.abs(la - lb) <= 0.1).mean() >= 0.90
