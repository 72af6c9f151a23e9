"""Port parity: ray queries of wave_tracer_tpu_torch (K1/K2 torch twins on
CPU) against the JAX package's trace_mxu/occluded_mxu (jnp reference of
the Pallas kernels) and trace_brute/occluded_brute (Möller–Trumbore).

Random soups and bars as in tests/test_mxu.py: ids agree on >= 99.9% of
rays (rare near-edge flips between Plücker and Möller–Trumbore), t within
rtol 1e-4, u/v within atol 1e-4. hit_attributes is compared at rtol 1e-5
on identical (t, tri, u, v) inputs."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_render import make_box_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.accel import mxu_trace
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu_torch.accel import ray_kernels
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.scene.bridge import scene_data_from_numpy
from wave_tracer_tpu_torch.util.stats import registry

cap_torch_threads()


def _soup(T=700, seed=0):
    rng = np.random.default_rng(seed)
    p0 = (rng.normal(size=(T, 3)) * 2 + 5.0).astype(np.float32)
    e1 = rng.normal(size=(T, 3)).astype(np.float32)
    e2 = rng.normal(size=(T, 3)).astype(np.float32)
    center = p0.mean(0)
    tri_geom = np.concatenate([p0, e1, e2, np.zeros((T, 3), np.float32)], 1)
    jgeo = types.SimpleNamespace(
        num_tris=T, p0=jnp.asarray(p0), e1=jnp.asarray(e1),
        e2=jnp.asarray(e2), tri_geom=jnp.asarray(tri_geom),
        tri_mxu=jnp.asarray(mxu_trace.build_tri_features(p0, e1, e2,
                                                         center)),
        mxu_center=jnp.asarray(center))
    t = torch.from_numpy
    tgeo = ttrace.GeoArrays(
        p0=t(p0), e1=t(e1), e2=t(e2), tri_geom=t(tri_geom),
        tri_attr=torch.zeros((T, 32)), mxu_center=t(center))
    return jgeo, tgeo


def _rays(N=512, seed=1):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(N, 3)) * 3 + 5.0).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("seed", [0, 5])
def test_closest_hit_parity(seed):
    jgeo, tgeo = _soup(seed=seed)
    ro, rd = _rays(seed=seed + 1)
    N = len(ro)
    tmin, tmax = np.full(N, 1e-4, np.float32), np.full(N, 1e30, np.float32)
    jargs = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmin),
             jnp.asarray(tmax))
    t1, i1, u1, v1 = [np.asarray(x) for x in ttrace.trace(
        tgeo, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(tmin), torch.from_numpy(tmax))]
    for ref in (jtrace.trace_brute(jgeo, *jargs),
                mxu_trace.trace_mxu(jgeo, *jargs, use_pallas=False)):
        t0, i0, u0, v0 = [np.asarray(x) for x in ref]
        assert (i0 == i1).mean() > 0.999
        hit = (i0 >= 0) & (i0 == i1)
        assert hit.any()
        np.testing.assert_allclose(t1[hit], t0[hit], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(u1[hit], u0[hit], atol=1e-4)
        np.testing.assert_allclose(v1[hit], v0[hit], atol=1e-4)
    assert (t1[i1 < 0] == np.float32(3.4e38)).all()


def test_anyhit_and_exclude_parity():
    jgeo, tgeo = _soup(seed=3)
    ro, rd = _rays(seed=4)
    N = len(ro)
    tmin = np.full(N, 1e-4, np.float32)
    tmax = np.full(N, 4.0, np.float32)
    big = np.full(N, 1e30, np.float32)
    T_ro, T_rd = torch.from_numpy(ro), torch.from_numpy(rd)
    occ0 = np.asarray(jtrace.occluded_brute(
        jgeo, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmin),
        jnp.asarray(tmax)))
    occ1 = ttrace.occluded(tgeo, T_ro, T_rd, torch.from_numpy(tmin),
                           torch.from_numpy(tmax)).numpy()
    assert (occ0 == occ1).mean() > 0.999
    # exclusions: the winner drops out of the closest hit, and excluding
    # it (plus two other ids) matches the JAX reference's any-hit
    _, i0, _, _ = ttrace.trace(tgeo, T_ro, T_rd, torch.from_numpy(tmin),
                               torch.from_numpy(big))
    _, i2, _, _ = ttrace.trace(tgeo, T_ro, T_rd, torch.from_numpy(tmin),
                               torch.from_numpy(big), i0)
    hit = i0.numpy() >= 0
    assert (i2.numpy()[hit] != i0.numpy()[hit]).all()
    _, ij, _, _ = mxu_trace.trace_mxu(
        jgeo, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmin),
        jnp.asarray(big), jnp.asarray(i0.numpy()), use_pallas=False)
    assert (np.asarray(ij) == i2.numpy()).mean() > 0.999
    ex2 = np.roll(i0.numpy(), 1)
    ex3 = np.roll(i0.numpy(), 2)
    occ_j = np.asarray(mxu_trace.occluded_mxu(
        jgeo, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmin),
        jnp.asarray(tmax), jnp.asarray(i0.numpy()), jnp.asarray(ex2),
        jnp.asarray(ex3), use_pallas=False))
    occ_t = ttrace.occluded(tgeo, T_ro, T_rd, torch.from_numpy(tmin),
                            torch.from_numpy(tmax), i0,
                            torch.from_numpy(ex2), torch.from_numpy(ex3))
    assert (occ_j == occ_t.numpy()).mean() > 0.999


def _flatten(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: np.asarray(obj)}


def test_hit_attributes_parity():
    scene = make_box_scene(res=8, spp=1)
    jb = jbuild(scene)
    tdata = scene_data_from_numpy(_flatten(jb.data), "cpu")
    sensor = scene.sensors[0]
    r = np.random.default_rng(7)
    N = 400
    pxy = np.stack([r.integers(0, 8, N), r.integers(0, 8, N)], -1)
    jit = r.random((N, 2)).astype(np.float32)
    ro, rd, _ = sensor.generate_rays(jnp.asarray(pxy, jnp.int32),
                                     jnp.asarray(jit))
    ro, rd = np.array(ro), np.array(rd)
    N_ = len(ro)
    t, tri, u, v = jtrace.trace(jb.data.geo, jnp.asarray(ro),
                                jnp.asarray(rd), jnp.full((N_,), 1e-4),
                                jnp.full((N_,), 1e30))
    t, tri, u, v = [np.asarray(x) for x in (t, tri, u, v)]
    assert (tri >= 0).mean() > 0.5
    jh = jtrace.hit_attributes(jb.data.geo, jnp.asarray(ro),
                               jnp.asarray(rd), jnp.asarray(t),
                               jnp.asarray(tri), jnp.asarray(u),
                               jnp.asarray(v))
    th = ttrace.hit_attributes(tdata.geo, *[torch.from_numpy(np.array(x))
                                            for x in (ro, rd, t, tri, u, v)])
    for f in dataclasses.fields(jh):
        a = np.asarray(getattr(jh, f.name))
        b = getattr(th, f.name).numpy()
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)
    # the port's own trace agrees with the JAX one on these camera rays
    t2, tri2, u2, v2 = ttrace.trace(tdata.geo, torch.from_numpy(ro),
                                    torch.from_numpy(rd),
                                    torch.full((N_,), 1e-4),
                                    torch.full((N_,), 1e30))
    assert (tri2.numpy() == tri).mean() > 0.999


def test_wrappers_run_twins_only_on_cpu():
    """A CPU tensor runs the twin (no launch counted); any device other
    than CPU or CUDA raises — nothing falls back."""
    _, tgeo = _soup(T=64)
    ro, rd = [torch.from_numpy(x) for x in _rays(N=32)]
    k1, k2 = (registry.counter(f"launches/{k}") for k in ("k1", "k2"))
    before = (k1.value, k2.value)
    ttrace.trace(tgeo, ro, rd, torch.full((32,), 1e-4),
                 torch.full((32,), 1e30))
    assert (k1.value, k2.value) == before
    meta = [x.to("meta") for x in (tgeo.tri_feat, tgeo.mxu_center, ro, rd)]
    ex = torch.full((32, 3), -1, dtype=torch.int32, device="meta")
    t = torch.zeros(32, device="meta")
    table = [x.to("meta") for x in tgeo.ray_table]
    with pytest.raises(NotImplementedError):
        ray_kernels.closest_hit(*meta, t, t, ex, table=table)
    with pytest.raises(NotImplementedError):
        ray_kernels.any_hit(*meta, t, t, ex, table=table)


def test_closest_hit_word_orders_like_t_then_id():
    """K1 merges the chunks of the triangle range with a 64-bit atomicMin on
    (order_key(t) << 32 | id). Packed here as the kernel packs it, the words
    sort like (t, then id) for t of either sign, and `_unpack` inverts them;
    the "no hit" word unpacks to (BIG, -1)."""
    r = np.random.default_rng(5)
    t = np.concatenate([r.normal(size=200) * 10.0 ** r.integers(-6, 6, 200),
                        [0.0, -0.0, 1e-30, -1e-30, 3.4e38, -3.4e38]]
                       ).astype(np.float32)
    ids = r.integers(0, 1 << 17, t.size).astype(np.uint64)
    b = t.view(np.uint32)
    key = np.where(b >> 31 == 1, ~b, b | np.uint32(1 << 31))
    word = (key.astype(np.uint64) << np.uint64(32)) | ids
    order = np.argsort(word, kind="stable")
    ref = np.lexsort((ids, t))
    np.testing.assert_array_equal(t[order], t[ref])
    tt, tri = ray_kernels._unpack(torch.from_numpy(word.view(np.int64)))
    np.testing.assert_array_equal(tt.numpy().view(np.uint32), b)
    np.testing.assert_array_equal(tri.numpy(), ids.astype(np.int32))
    tt, tri = ray_kernels._unpack(torch.tensor([ray_kernels._NO_HIT]))
    assert tt.item() == np.float32(ray_kernels.BIG) and tri.item() == -1


@pytest.mark.parametrize("mask", ["random", "none_set", "all_set"])
def test_occluded_need_mask(mask):
    """occluded(..., need=m) is occluded(...) & m: rows outside the mask
    are False (the kernel never traces them), the rest unchanged; with
    exclusions, as the wave bounce passes them."""
    _, tgeo = _soup(seed=8)
    ro, rd = [torch.from_numpy(x) for x in _rays(seed=9)]
    N = ro.shape[0]
    r = np.random.default_rng(10)
    m = {"random": torch.from_numpy(r.random(N) < 0.3),
         "none_set": torch.zeros(N, dtype=torch.bool),
         "all_set": torch.ones(N, dtype=torch.bool)}[mask]
    ex = [torch.from_numpy(r.integers(-1, 700, N).astype(np.int32))
          for _ in range(3)]
    args = (tgeo, ro, rd, torch.full((N,), 1e-4),
            torch.from_numpy(r.uniform(0.5, 6.0, N).astype(np.float32)),
            *ex)
    full = ttrace.occluded(*args)
    assert full.any() and (~full).any()
    assert torch.equal(ttrace.occluded(*args, need=m), full & m)


def test_need_list():
    """The device-side need list: the set rows in order, then the count,
    with no host read of the mask."""
    r = np.random.default_rng(12)
    for need in (torch.from_numpy(r.random(1000) < 0.1),
                 torch.zeros(7, dtype=torch.bool),
                 torch.ones(5, dtype=torch.bool)):
        rows, count = ray_kernels.need_list(need)
        n = int(count)
        assert rows.dtype == count.dtype == torch.int32
        assert rows.shape == (need.shape[0] + 1,) and count.shape == (1,)
        assert n == int(need.sum())
        assert torch.equal(rows[:n].long(), need.nonzero().squeeze(1))


def test_pack_inverts_unpack():
    """`_pack` builds K1's words from (t, tri), the carried hit of a row
    the kernel does not trace: bit for bit the inverse of `_unpack`, for t
    of either sign, and a miss (BIG, -1) packs to the "no hit" word."""
    r = np.random.default_rng(6)
    t = np.concatenate([r.normal(size=300) * 10.0 ** r.integers(-6, 6, 300),
                        [0.0, -0.0, 3.4e38, -3.4e38]]).astype(np.float32)
    tri = np.where(r.random(t.size) < 0.2, -1,
                   r.integers(0, 1 << 17, t.size)).astype(np.int32)
    word = ray_kernels._pack(torch.from_numpy(t), torch.from_numpy(tri))
    assert word.dtype == torch.int64
    tt, ti = ray_kernels._unpack(word)
    np.testing.assert_array_equal(tt.numpy().view(np.uint32),
                                  t.view(np.uint32))
    np.testing.assert_array_equal(ti.numpy(), tri)
    miss = ray_kernels._pack(torch.tensor([np.float32(ray_kernels.BIG)]),
                             torch.tensor([-1], dtype=torch.int32))
    assert miss.item() == ray_kernels._NO_HIT


@pytest.mark.parametrize("mask", ["random", "none_set", "all_set"])
def test_closest_hit_need_and_carry(mask):
    """trace(..., need=m, carry=(t, tri)): rows off the mask return the
    carried (t, tri) bit for bit, untraced, with u/v of that triangle;
    rows on it return what tracing every row returns; without a carry the
    rows off the mask are misses. With exclusions, as the bounces pass
    them."""
    _, tgeo = _soup(seed=13)
    ro, rd = [torch.from_numpy(x) for x in _rays(seed=14)]
    N = ro.shape[0]
    r = np.random.default_rng(15)
    m = {"random": torch.from_numpy(r.random(N) < 0.3),
         "none_set": torch.zeros(N, dtype=torch.bool),
         "all_set": torch.ones(N, dtype=torch.bool)}[mask]
    args = (tgeo, ro, rd, torch.full((N,), 1e-4), torch.full((N,), 1e30),
            torch.from_numpy(r.integers(-1, 700, N).astype(np.int32)))
    t0, i0, u0, v0 = ttrace.trace(*args)
    assert (i0 >= 0).any() and (i0 < 0).any()
    # a carry that differs from the trace everywhere: another draw's hits
    ct, ci, _, _ = ttrace.trace(tgeo, ro, -rd, *args[3:])
    ct, ci = ct + 1.0, torch.where(ci >= 0, 699 - ci, 5)
    t1, i1, u1, v1 = ttrace.trace(*args, need=m, carry=(ct, ci))
    np.testing.assert_array_equal(t1[~m].numpy().view(np.uint32),
                                  ct[~m].numpy().view(np.uint32))
    assert torch.equal(i1[~m], ci[~m])
    np.testing.assert_array_equal(t1[m].numpy().view(np.uint32),
                                  t0[m].numpy().view(np.uint32))
    assert torch.equal(i1[m], i0[m])
    assert torch.equal(u1[m], u0[m]) and torch.equal(v1[m], v0[m])
    # the carried row's u/v are those of the carried triangle, recomputed
    _, _, uc, vc = ray_kernels.trace_rays(tgeo, ro, rd, *args[3:],
                                          need=torch.zeros_like(m),
                                          carry=(ct, ci))
    assert torch.equal(u1[~m], uc[~m]) and torch.equal(v1[~m], vc[~m])
    t2, i2, _, _ = ttrace.trace(*args, need=m)
    assert (t2[~m] == np.float32(ray_kernels.BIG)).all()
    assert (i2[~m] == -1).all() and torch.equal(i2[m], i0[m])
