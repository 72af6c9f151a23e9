"""Geometry derivatives through K3's per-boundary minima on the wave
plt_path, held against the JAX package's exact-AD plain cone query.

A diffusive lane that meets no triangle under its central ray interacts
midflight at z_region, the earliest cone–triangle entry past its segment
boundary; that point feeds the next vertex, the FSD evaluation and the
footprint. K3 returns the minima detached, so `accel/trace.py::
cone_boundary_minz` asks its winner build for each minimum's triangle and
recomputes that pair's entry z differentiably (`cone_kernels.minz_pairs`)
where a derivative is in play.

The JAX reference: its plain cone query (`accel/trace.py::
cone_boundary_minz`, what the package runs off the TPU with
WT_CONE_QUERY unset; the mxu cone route reads features baked once from
numpy, so it cannot follow a moved triangle), and its ray queries through
the plain references of its Pallas kernels, whose picks K1/K2 port; the
closest hit's t there follows the rays only (the triangle features are
baked from numpy too), so `exact_t_references` gives it the
Möller–Trumbore derivative of the winning triangle instead, as the
package's exact-AD CPU trace and the port's K1 wrapper both take it.

Two moves of the wave box (FSD on, 8×8 × 1 spp, depth 3, the wave
gradient tests' setup), their pixel maps at the wave bars of PERF.md §2:
the back wall along +z, and the left wall slid along z in its own plane.
The slide changes only where cones graze the wall's front edge, so its
whole map is the z_region term: without the repair it is zero. FSD off
(the classical path), the back wall's map per lane at rtol 1e-4.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from test_render import make_box_scene
from test_torch_gradients import (BACK_WALL, LEFT_WALL, WALL_DEPTH, WALL_KEY,
                                  _flatten, _translate_j, _translate_t, lanes,
                                  port_jvp, wave_bars)
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.accel import mxu_trace as jmxu
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.integrator.path import trace_paths as jtrace_paths
from wave_tracer_tpu.integrator.plt_path import \
    trace_paths_wave as jtrace_paths_wave
from wave_tracer_tpu.sampling import rng as jrng
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.wave.envelope import EnvState as JEnvState
from wave_tracer_tpu_torch.accel import cone_kernels
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.integrator.path import trace_paths
from wave_tracer_tpu_torch.integrator.plt_path import trace_paths_wave
from wave_tracer_tpu_torch.integrator.traversal import segment_boundaries
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.scene.procedural import \
    make_box_scene as tmake_box_scene
from wave_tracer_tpu_torch.wave.envelope import EnvState

cap_torch_threads()

RES, DEPTH, KEY = 8, 3, 3          # test_gradients_wave.py's setup
# (shape, direction) of each move: the back wall along +z; the left wall
# (x = −1, spanning z ∈ [−1, 1]) slid along z in its own plane
MOVES = {"back_wall": (BACK_WALL, (0.0, 0.0, 1.0)),
         "left_wall_slide": (LEFT_WALL, (0.0, 0.0, 1.0))}


def _exact_t_trace_mxu(geo, ro, rd, tmin, tmax, exclude_tri=None, *,
                       use_pallas=True):
    t, tri, u, v = _TRACE_MXU(geo, ro, rd, tmin, tmax, exclude_tri,
                              use_pallas=False)
    row = geo.tri_geom[jnp.maximum(tri, 0)]
    p0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    det = jnp.sum(e1 * jnp.cross(rd, e2), axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12,
                        1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    t_mt = jnp.sum(e2 * jnp.cross(ro - p0, e1), axis=-1) * inv_det
    # the reference's t carries the derivative of its ray features only
    t = jax.lax.stop_gradient(t)
    return (jnp.where(tri >= 0, t + (t_mt - jax.lax.stop_gradient(t_mt)), t),
            tri, u, v)


_TRACE_MXU = jmxu.trace_mxu


@contextlib.contextmanager
def exact_t_references():
    """The JAX ray queries through its kernels' plain references, the
    closest hit's t with its Möller–Trumbore derivative; the cone query
    its plain exact-AD sweep."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jtrace, "_tpu_like", lambda: True)
        m.setattr(jmxu, "_launch", jmxu._launch_ref)
        m.setattr(jmxu, "trace_mxu", _exact_t_trace_mxu)
        m.delenv("WT_CONE_QUERY", raising=False)
        yield


def _move_j(data, th):
    for i, (shape, d) in enumerate(MOVES.values()):
        data = _translate_j(data, shape, th[i] * jnp.asarray(d))
    return data


@pytest.fixture(scope="module")
def box():
    wave = make_box_scene(res=RES, spp=1)
    classical = make_box_scene(res=RES, spp=1)
    classical.integrator.fsd = False
    out = {}
    for tag, scene in (("wave", wave), ("classical", classical)):
        jb = jbuild(scene)
        out[tag] = dict(jb=jb, scene=scene,
                        data=scene_data_from_numpy(_flatten(jb.data), "cpu"))
    out["sensor"] = tmake_box_scene(res=RES, spp=1).sensors[0]
    return out


@pytest.fixture(scope="module")
def jax_results(box):
    """The JAX image and its derivative w.r.t. each move (jvp over a
    batch of tangents: one compile for both; the image is the jvp's
    primal, as the wave gradient tests take it), and the classical path's
    map w.r.t. the back wall (test_gradients_breadth.py's depth and
    key)."""
    pxy, jit, sids = (jnp.asarray(x) for x in lanes(RES))
    jw, jc = box["wave"]["jb"], box["classical"]["jb"]

    def wave(th):
        data = _move_j(jw.data, th)
        return jtrace_paths_wave(
            data, pxy, jit, jrng.make_base_key(KEY), sids,
            sensor=box["wave"]["scene"].sensors[0], edge_table=data.edges,
            max_depth=DEPTH, eps=1e-4)[1]

    def classical(th):
        data = _translate_j(jc.data, BACK_WALL,
                            th * jnp.asarray([0.0, 0.0, 1.0]))
        return jtrace_paths(data, pxy, jit, jrng.make_base_key(WALL_KEY),
                            sids, sensor=box["classical"]["scene"].sensors[0],
                            max_depth=WALL_DEPTH, eps=1e-4)[1]

    with exact_t_references():
        values, jac = jax.jit(lambda t: jax.vmap(lambda v: jax.jvp(
            wave, (t,), (v,)))(jnp.eye(len(MOVES))))(jnp.zeros(len(MOVES)))
        cl_values, cl_map = jax.jit(lambda t: jax.jvp(
            classical, (t,), (1.0,)))(0.0)
    out = {name: np.asarray(jac[i]) for i, name in enumerate(MOVES)}
    out.update(values=np.asarray(values[0]), classical_values=np.asarray(
        cl_values), classical_map=np.asarray(cl_map))
    return out


def _port_map(box, move):
    shape, d = MOVES[move]
    data = box["wave"]["data"]
    pxy, jit, sids = (torch.from_numpy(x) for x in lanes(RES))

    def f(th):
        moved = _translate_t(data, shape, th * torch.tensor(d))
        return trace_paths_wave(moved, pxy, jit, KEY, sids,
                                sensor=box["sensor"], edge_table=moved.edges,
                                max_depth=DEPTH, eps=1e-4)[1]
    return port_jvp(f, torch.tensor(0.0), torch.tensor(1.0))


@pytest.mark.parametrize("move", list(MOVES))
def test_wave_wall_maps_match_jax(box, jax_results, move):
    """The forward-mode pixel map through trace_paths_wave (FSD on)
    against JAX's jacfwd at the wave bars (Pearson ≥ 0.999, ≥ 90% of
    pixels within 1e-2·max(|ref|, mean|ref|)). The slide's map is all
    z_region: detached minima give zero there."""
    img, g = _port_map(box, move)
    img, g = img.numpy(), g.numpy()
    ref = jax_results[move]
    assert np.isfinite(g).all()
    assert (np.abs(ref) > 0).any() and (np.abs(g) > 0).any()
    pearson, share = wave_bars(img, jax_results["values"])
    assert pearson >= 0.999 and share >= 0.90
    pearson, share = wave_bars(g, ref)
    assert pearson >= 0.999 and share >= 0.90, (pearson, share)


def test_classical_wall_map_per_lane(box, jax_results):
    """FSD off (the classical path, no cone query): the back wall's map
    per lane at rtol 1e-4 against JAX through the same ray picks."""
    data = box["classical"]["data"]
    pxy, jit, sids = (torch.from_numpy(x) for x in lanes(RES))
    zhat = torch.tensor([0.0, 0.0, 1.0])
    p, g = port_jvp(lambda th: trace_paths(
        _translate_t(data, BACK_WALL, th * zhat), pxy, jit, WALL_KEY, sids,
        sensor=box["sensor"], max_depth=WALL_DEPTH, eps=1e-4)[1],
        torch.tensor(0.0), torch.tensor(1.0))
    ref, ref_map = jax_results["classical_values"], jax_results[
        "classical_map"]
    assert (ref_map != 0).any()
    np.testing.assert_allclose(p.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(g.numpy(), ref_map, rtol=1e-4,
                               atol=1e-4 * np.abs(ref_map).max())


def _cones(n, seed):
    """n seeded narrow cones from in front of the box's opening into it
    (numpy): ro, rd, xh, e, x0, ta, zmax, wavelength."""
    r = np.random.default_rng(seed)
    ro = np.stack([r.uniform(-1.5, 1.5, n), r.uniform(0.0, 2.0, n),
                   r.uniform(1.5, 3.5, n)], -1)
    tgt = np.stack([r.uniform(-1.2, 1.2, n), r.uniform(-0.2, 2.2, n),
                    r.uniform(-1.0, 1.2, n)], -1)
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    xh = np.cross(rd, r.normal(size=(n, 3)))
    xh /= np.linalg.norm(xh, axis=-1, keepdims=True)
    f32 = np.float32
    return (ro.astype(f32), rd.astype(f32), xh.astype(f32),
            r.uniform(1.0, 1.5, n).astype(f32),
            r.uniform(1e-3, 0.05, n).astype(f32),
            r.uniform(1e-3, 0.05, n).astype(f32), np.full(n, 10.0, f32),
            r.uniform(380e-9, 720e-9, n).astype(f32))


@pytest.mark.parametrize("move", list(MOVES))
def test_cone_minima_tangents_match_jax(box, move):
    """cone_boundary_minz in forward mode w.r.t. a wall move: the minima
    keep K3's values (its plain twin's here) and their tangents are the
    JAX plain query's jvp, which is non-zero on this scene."""
    shape, d = MOVES[move]
    ro, rd, xh, e, x0, ta, zmax, lam = _cones(1024, 5)
    jb = box["wave"]["jb"]
    bounds = segment_boundaries(torch.from_numpy(lam))

    def jz(p0):
        geo = jb.data.geo.replace(p0=p0)
        return jtrace.cone_boundary_minz(
            geo, jnp.asarray(ro), jnp.asarray(rd),
            JEnvState(x=jnp.asarray(xh), x0=jnp.asarray(x0),
                      ta=jnp.asarray(ta), e=jnp.asarray(e)),
            jnp.asarray(bounds.numpy()), jnp.asarray(zmax))[0]

    sid = np.asarray(jb.data.geo.shape_id)
    dp = ((sid == shape)[:, None] * np.float32(d)).astype(np.float32)
    zj, tj = (np.asarray(x) for x in jax.jvp(jz, (jb.data.geo.p0,),
                                             (jnp.asarray(dp),)))
    data = box["wave"]["data"]
    geo = data.geo
    plain = ttrace.cone_boundary_minz(
        geo, *(torch.from_numpy(x) for x in (ro, rd)),
        EnvState(*(torch.from_numpy(x) for x in (xh, x0, ta, e))), bounds,
        torch.from_numpy(zmax))[0]
    with fwAD.dual_level():
        th = fwAD.make_dual(torch.tensor(0.0), torch.tensor(1.0))
        moved = _translate_t(data, shape, th * torch.tensor(d)).geo
        zc = ttrace.cone_boundary_minz(
            moved, *(torch.from_numpy(x) for x in (ro, rd)),
            EnvState(*(torch.from_numpy(x) for x in (xh, x0, ta, e))),
            bounds, torch.from_numpy(zmax))[0]
        zp, tp = fwAD.unpack_dual(zc)
    zp, tp = zp.numpy(), tp.numpy()
    assert np.array_equal(zp, plain.numpy())          # the kernel's value
    fin = np.isfinite(zp) & np.isfinite(zj)
    assert (np.isfinite(zp) == np.isfinite(zj)).mean() >= 0.999
    np.testing.assert_allclose(zp[fin], zj[fin], rtol=1e-5, atol=1e-5)
    moving = fin & (tj != 0)
    assert moving.sum() >= 16
    close = np.isclose(tp[fin], tj[fin], rtol=1e-4, atol=1e-5)
    assert close.mean() >= 0.999, (close.mean(), (~close).sum())


def test_minz_ref_winners_are_the_argmin():
    """The plain twin's winners: for each boundary the triangle of least
    z ≥ the boundary, the least id among equal z (duplicated triangles
    tie exactly, across the twin's 512-triangle tiles too), −1 where
    none; the minima and counts are those of the build without winners."""
    r = np.random.default_rng(3)
    T0, N = 400, 256
    p0 = r.normal(size=(T0, 3)).astype(np.float32) * 2
    e1 = r.normal(size=(T0, 3)).astype(np.float32)
    e2 = r.normal(size=(T0, 3)).astype(np.float32)
    tri = cone_kernels.cone_tris(*(torch.from_numpy(np.concatenate([x, x]))
                                   for x in (p0, e1, e2)))
    T = tri.shape[0]                  # 800: triangle i ties with i + 400
    ro = torch.from_numpy(r.normal(size=(N, 3)).astype(np.float32) * 3)
    rd = torch.nn.functional.normalize(-ro + torch.from_numpy(
        r.normal(size=(N, 3)).astype(np.float32)), dim=-1)
    xh = torch.nn.functional.normalize(torch.linalg.cross(rd, torch.randn(
        N, 3, generator=torch.Generator().manual_seed(0))), dim=-1)
    f = [torch.from_numpy(x.astype(np.float32)) for x in (
        r.uniform(0.6, 1.0, N), r.uniform(0.01, 0.3, N),
        r.uniform(0.01, 0.2, N), r.uniform(2.0, 12.0, N))]
    exclude = torch.from_numpy(np.where(r.random(N) < 0.3,
                                        r.integers(0, T, N), -1)
                               .astype(np.int32))
    bnd = torch.sort(torch.from_numpy(r.uniform(0, 8, (N, 16))
                                      .astype(np.float32)), dim=1)[0]
    args = (tri, ro, rd, xh, *f, exclude, bnd, 1e-7)
    zc, cnt, win = cone_kernels._minz_ref(*args, winners=True)
    zc0, cnt0 = cone_kernels._minz_ref(*args)
    assert torch.equal(zc, zc0) and torch.equal(cnt, cnt0)
    # brute force over every pair at once
    z = cone_kernels._minz_block(
        *cone_kernels._local_coords(tri, ro, rd, xh, f[0]),
        *(v[:, None] for v in f[1:]), 1e-7)
    ids = torch.arange(T, dtype=torch.int32)
    z = torch.where((z < cone_kernels.BIG) & (ids != exclude[:, None]), z,
                    cone_kernels.BIG)
    for j in range(16):
        zm = torch.where(z >= bnd[:, j:j + 1], z, cone_kernels.BIG)
        zj = zm.amin(1)
        wj = torch.where(zm == zj[:, None], ids, T).amin(1)
        none = zj >= cone_kernels.BIG
        assert torch.equal(zc[:, j], torch.where(none, float("inf"), zj))
        assert torch.equal(win[:, j], torch.where(none, -1, wj).int())
    found = win >= 0
    assert found.float().mean() > 0.2 and (win[found] < T0).all()
    assert ((win >= 0) == torch.isfinite(zc)).all()


def test_no_derivative_asks_no_winners(box, monkeypatch):
    """With no derivative in play cone_boundary_minz runs the query alone
    (no winners, no recompute); with one it recomputes."""
    calls = []
    real = cone_kernels.minz_pairs
    monkeypatch.setattr(cone_kernels, "minz_pairs",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ro, rd, xh, e, x0, ta, zmax, lam = (torch.from_numpy(x)
                                        for x in _cones(64, 6))
    env = EnvState(x=xh, x0=x0, ta=ta, e=e)
    geo = box["wave"]["data"].geo
    bounds = segment_boundaries(lam)
    zc, _ = ttrace.cone_boundary_minz(geo, ro, rd, env, bounds, zmax)
    assert not calls
    ro_g = ro.clone().requires_grad_(True)
    zg, _ = ttrace.cone_boundary_minz(geo, ro_g, rd, env, bounds, zmax)
    assert calls and torch.equal(zg.detach(), zc)
    fin = torch.isfinite(zg)
    zg[fin].sum().backward()
    assert torch.isfinite(ro_g.grad).all() and (ro_g.grad != 0).any()


def test_grazing_edge_has_a_finite_derivative():
    """A cone from near the box's ceiling corner whose winning entry is the
    corner edge itself, where the edge quadratic's discriminant is 0 (met
    at 64×64, depth 8): the entry's derivative is finite in both AD modes
    (sqrt(max(disc, 0)) had ∞ · 0 = NaN there)."""
    f32 = torch.float32
    verts = torch.tensor([[[1.0, 2.0, 1.0, 1.0, 2.0, -1.0, 1.0, 0.0, -1.0]]])
    lane = [torch.tensor([v], dtype=f32) for v in (
        [0.9774119853973389, 1.9774119853973389, 0.8947372436523438],
        [0.36363154649734497, 0.36363154649734497, -0.8576386570930481],
        [0.9315427541732788, -0.14194506406784058, 0.33478274941444397])]
    scal = [torch.tensor([v], dtype=f32) for v in (
        1.0, 9.999999974752427e-07, 1.4126369023870211e-05,
        0.06336122006177902)]
    with fwAD.dual_level():
        ro = fwAD.make_dual(lane[0], torch.tensor([[0.0, 0.0, 1.0]]))
        z = cone_kernels.minz_pairs(verts, ro, *lane[1:], *scal)
        zp, zt = fwAD.unpack_dual(z)
    assert 0.06 < float(zp) < 0.0634 and torch.isfinite(zt).all()
    ro = lane[0].clone().requires_grad_(True)
    cone_kernels.minz_pairs(verts, ro, *lane[1:], *scal).sum().backward()
    assert torch.isfinite(ro.grad).all()


def jax_ulp_spread(res=64, depth=8):
    """The JAX package's own wave maps w.r.t. each move at res² lanes,
    depth `depth` (the chip's phase 26 size), against themselves with the
    wall moved one ulp (2^-23) either way: Pearson, and the largest
    change of a value over the largest value. Prints them."""
    scene = make_box_scene(res=res, spp=1)
    jb = jbuild(scene)
    pxy, jit, sids = (jnp.asarray(x) for x in lanes(res))
    with exact_t_references():
        for name, (shape, d) in MOVES.items():
            def f(th):
                data = _translate_j(jb.data, shape, th * jnp.asarray(d))
                return jtrace_paths_wave(
                    data, pxy, jit, jrng.make_base_key(KEY), sids,
                    sensor=scene.sensors[0], edge_table=data.edges,
                    max_depth=depth, eps=1e-4)[1]
            jvp = jax.jit(lambda th: jax.jvp(f, (th,), (jnp.float32(1.0),)))
            v0, g0 = (np.asarray(x) for x in jvp(jnp.float32(0.0)))
            for at in (2.0 ** -23, -2.0 ** -23):
                v, g = (np.asarray(x) for x in jvp(jnp.float32(at)))
                print(f"JAX {name} {res}x{res} depth {depth}, moved {at:+.3e}:"
                      f" map Pearson {np.corrcoef(g.ravel(), g0.ravel())[0, 1]:.6f}"
                      f" against unmoved, values within "
                      f"{np.abs(v - v0).max() / np.abs(v0).max():.3e} of max",
                      flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax_ulp_spread()
