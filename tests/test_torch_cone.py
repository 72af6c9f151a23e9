"""Port parity for the cone-triangle boundary sweep (K3's plain version):
wave_tracer_tpu_torch.accel.trace.cone_boundary_minz on the CPU against the
JAX package's XLA sweep (accel.trace.cone_boundary_minz) and its MXU
kernel's jnp reference (mxu_cone.cone_boundary_minz_mxu,
use_pallas=False), on the random scene and lanes of tests/test_mxu_cone.py.

The bars are test_mxu_cone.py's, which hold the two JAX strategies
against each other: the same exact entry math, executed differently, so
membership tests at the envelope edge may flip for a few pairs:
  * finite masks agree on > 99.9% of entries;
  * minima within rtol/atol 2e-4 where both are finite;
  * counts within max(2, 2%) on > 97% of lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from test_mxu_cone import _Geo, _lanes, _random_scene
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.accel import mxu_cone
from wave_tracer_tpu.accel import trace as jtrace
from wave_tracer_tpu.integrator import traversal as jtraversal
from wave_tracer_tpu_torch.accel import cone_kernels
from wave_tracer_tpu_torch.accel import trace as ttrace
from wave_tracer_tpu_torch.util.stats import registry
from wave_tracer_tpu_torch.wave.envelope import EnvState

cap_torch_threads()


def _t(x):
    return torch.tensor(np.asarray(x))


def _torch_geo(p0, e1, e2):
    t = torch.from_numpy
    T = len(p0)
    return ttrace.GeoArrays(
        p0=t(p0), e1=t(e1), e2=t(e2), tri_geom=torch.zeros((T, 12)),
        tri_attr=torch.zeros((T, 32)), mxu_center=torch.zeros(3))


def _torch_env(env):
    return EnvState(**{k: _t(getattr(env, k)) for k in ("x", "x0", "ta",
                                                          "e")})


def _agree(zc, cnt, zc_ref, cnt_ref):
    zc, zc_ref = np.asarray(zc), np.asarray(zc_ref)
    cnt, cnt_ref = np.asarray(cnt), np.asarray(cnt_ref)
    finite = np.isfinite(zc_ref)
    assert finite.any()
    assert (np.isfinite(zc) == finite).mean() > 0.999
    both = finite & np.isfinite(zc)
    np.testing.assert_allclose(zc[both], zc_ref[both], rtol=2e-4, atol=2e-4)
    assert (np.abs(cnt - cnt_ref)
            <= np.maximum(2, 0.02 * cnt_ref)).mean() > 0.97


@pytest.mark.parametrize("T,N", [(700, 256), (300, 256), (700, 200)])
def test_cone_boundary_minz_parity(T, N):
    """T=700 spans two 512-triangle tiles; T=300 is less than one tile;
    N=200 is not a multiple of the kernel's 256-lane block."""
    p0, e1, e2 = _random_scene(T)
    jgeo = _Geo(p0, e1, e2)
    ro, rd, env = _lanes(N)
    lam = jnp.full((N,), 0.05)
    bounds = jtraversal.segment_boundaries(lam)
    zmax = jnp.full((N,), 30.0)
    exclude = jnp.arange(N, dtype=jnp.int32) % T

    zc_x, cnt_x = jtrace.cone_boundary_minz(
        jgeo, ro, rd, env, bounds, zmax, exclude_tri=exclude)
    zc_m, cnt_m = mxu_cone.cone_boundary_minz_mxu(
        jgeo, ro, rd, env, bounds, zmax, exclude_tri=exclude,
        use_pallas=False)
    zc, cnt = ttrace.cone_boundary_minz(
        _torch_geo(p0, e1, e2), _t(ro), _t(rd), _torch_env(env), _t(bounds),
        _t(zmax), exclude_tri=_t(exclude))
    assert zc.shape == (N, 16) and zc.dtype == torch.float32
    assert cnt.shape == (N,) and cnt.dtype == torch.int32
    _agree(zc.numpy(), cnt.numpy(), zc_x, cnt_x)
    _agree(zc.numpy(), cnt.numpy(), zc_m, cnt_m)


def test_fewer_boundaries_and_no_triangles():
    """B < 16 boundaries are padded inside and cut from the result; an
    empty scene meets nothing."""
    p0, e1, e2 = _random_scene(64)
    ro, rd, env = _lanes(32)
    args = (_t(ro), _t(rd), _torch_env(env))
    bounds = _t(jtraversal.segment_boundaries(jnp.full((32,), 0.05)))
    zmax = torch.full((32,), 30.0)
    geo = _torch_geo(p0, e1, e2)
    zc16, cnt16 = ttrace.cone_boundary_minz(geo, *args, bounds, zmax)
    zc5, cnt5 = ttrace.cone_boundary_minz(geo, *args, bounds[:, :5], zmax)
    torch.testing.assert_close(zc5, zc16[:, :5])
    assert torch.equal(cnt5, cnt16)
    e = np.zeros((0, 3), np.float32)
    zc0, cnt0 = ttrace.cone_boundary_minz(_torch_geo(e, e, e), *args,
                                          bounds, zmax)
    assert torch.isinf(zc0).all() and (cnt0 == 0).all()


def _need_mask(kind, N):
    if kind == "random":
        return torch.from_numpy(np.random.default_rng(5).random(N) < 0.4)
    need = torch.full((N,), kind == "all")
    if kind == "one":
        need[N // 3] = True
    return need


@pytest.mark.parametrize("derivative", [False, True])
@pytest.mark.parametrize("mask", ["random", "all", "none", "one"])
def test_cone_boundary_minz_need(mask, derivative):
    """Rows on `need` get, bit for bit, what the call without a mask gives
    them, and with a derivative in play (forward mode w.r.t. the lanes'
    origins, through the winner build) the same tangents; rows off it get
    the no-encounter answer, inf minima, a count of 0 and no derivative.
    The rows counters add the call's rows on and off `need`."""
    T, N = 700, 200
    p0, e1, e2 = _random_scene(T)
    geo = _torch_geo(p0, e1, e2)
    ro, rd, env = _lanes(N)
    ro, rd, env = _t(ro), _t(rd), _torch_env(env)
    bounds = _t(jtraversal.segment_boundaries(jnp.full((N,), 0.05)))
    zmax = torch.full((N,), 30.0)
    exclude = (torch.arange(N, dtype=torch.int32) * 7) % T
    need = _need_mask(mask, N)
    d_ro = torch.from_numpy(np.random.default_rng(6).normal(
        size=(N, 3)).astype(np.float32))
    swept = registry.counter("k3/rows_swept")
    skipped = registry.counter("k3/rows_skipped")

    def sweep(rows):
        """(minima, their tangents or None, counts, rows swept, skipped)."""
        before = swept.value, skipped.value
        with fwAD.dual_level():
            o = fwAD.make_dual(ro, d_ro) if derivative else ro
            zc, cnt = ttrace.cone_boundary_minz(geo, o, rd, env, bounds, zmax,
                                                exclude_tri=exclude,
                                                need=rows)
            z, dz = fwAD.unpack_dual(zc)
        return (z, dz, cnt, swept.value - before[0],
                skipped.value - before[1])

    z_all, dz_all, cnt_all, n_all, _ = sweep(None)
    z, dz, cnt, n_swept, n_skipped = sweep(need)
    M = int(need.sum())
    assert (n_all, n_swept, n_skipped) == (N, M, N - M)
    assert torch.equal(z[need].view(torch.int32),
                       z_all[need].view(torch.int32))
    assert torch.equal(cnt[need], cnt_all[need])
    assert torch.isinf(z[~need]).all() and (cnt[~need] == 0).all()
    assert torch.isfinite(z_all).any(1).float().mean() > 0.3
    if not derivative:
        assert dz_all is None and dz is None
        return
    fin = torch.isfinite(z_all)
    assert (dz_all[fin] != 0).float().mean() > 0.5
    if M:
        assert torch.equal(dz[need], dz_all[need])
    assert dz is None or (dz[~need] == 0).all()


def test_cone_kernel_wrapper_devices():
    """A CPU tensor runs the plain version; any other device raises rather
    than falling back, and the launch count moves only on a launch."""
    p0, e1, e2 = _random_scene(16)
    geo = _torch_geo(p0, e1, e2)
    N = 4
    lane = [torch.zeros((N, 3)), torch.tensor([[0.0, 0.0, 1.0]] * N),
            torch.tensor([[1.0, 0.0, 0.0]] * N)]
    ones = torch.ones(N)
    args = (geo.cone_tris, *lane, ones, ones * 0.1, ones * 0.1, ones * 10,
            torch.full((N,), -1, dtype=torch.int32), torch.zeros((N, 16)))
    k3 = registry.counter("launches/k3")
    before = k3.value
    zc, cnt = cone_kernels.cone_minz(*args, table=geo.cone_table)
    assert zc.shape == (N, 16) and cnt.dtype == torch.int32
    assert k3.value == before
    with pytest.raises(NotImplementedError):
        cone_kernels.cone_minz(*[a.to("meta") for a in args],
                               table=[x.to("meta") for x in geo.cone_table])


def test_cone_minz_ignores_default_dtype():
    """The plain sweep gives the same bits whatever torch's default dtype:
    a state that one test could leave for the next in the same worker.
    (Under float64 the K3 plain version once promoted its safe division,
    and with it every entry z, to float64.)"""
    N = 64
    p0, e1, e2 = _random_scene(300)
    ro, rd, env = _lanes(N)
    bounds = _t(jtraversal.segment_boundaries(jnp.full((N,), 0.05)))

    def sweep():
        return ttrace.cone_boundary_minz(
            _torch_geo(p0, e1, e2), _t(ro), _t(rd), _torch_env(env), bounds,
            torch.full((N,), 30.0, dtype=torch.float32))

    zc, cnt = sweep()
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        zc64, cnt64 = sweep()
    finally:
        torch.set_default_dtype(old)
    assert zc64.dtype == torch.float32
    assert torch.equal(zc64.view(torch.int32), zc.view(torch.int32))
    assert torch.equal(cnt64, cnt)


def test_plain_sqrt_rounds_as_ieee():
    """The plain version's square roots round as the kernel's IEEE sqrtf
    does, correctly, so that its minima stay bit-equal to K3's: on seeded
    draws, at 0 and below, and at NaN. torch's float32 sqrt on the CPU
    misses the correctly rounded root on some inputs (the share of these
    draws is printed)."""
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.uniform(0.0, 100.0, 1 << 20).astype(np.float32))
    exact = torch.from_numpy(
        np.sqrt(x.numpy().astype(np.float64)).astype(np.float32))
    assert torch.equal(cone_kernels._sqrt0(x), exact)
    print(f"torch.sqrt one ulp off on "
          f"{float((torch.sqrt(x) != exact).float().mean()):.4%} of draws")
    edge = cone_kernels._sqrt0(torch.tensor([0.0, -1.0, float("nan")]))
    assert edge[:2].tolist() == [0.0, 0.0] and torch.isnan(edge[2])
