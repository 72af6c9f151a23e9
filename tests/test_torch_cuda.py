"""K1/K2/K3 and the classical and wave renders on a CUDA card against the
plain torch versions. Marked `gpu`: each test skips without a card. This file imports no
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
    ex = torch.from_numpy(r.integers(-1, T, (N, 3)).astype(np.int32)).to(dev)
    return feat, center, t[3], t[4], ex


@pytest.mark.gpu
def test_kernels_match_twins(cuda):
    feat, center, ro, rd, ex = _soup_rays(cuda)
    N = ro.shape[0]
    # a negative tmin admits hits behind the origin (negative t), which the
    # kernel's cross-chunk merge must order like positive ones
    for tmin_v, tmax_v in ((1e-4, 1e30), (1e-4, 3.0), (-20.0, 1e30)):
        tmin = torch.full((N,), tmin_v, device=cuda)
        tmax = torch.full((N,), tmax_v, device=cuda)
        args = (feat, center, ro, rd, tmin, tmax, ex)
        before = dict(rk.LAUNCHES)
        tk, ik = rk.closest_hit(*args)
        tr, ir = rk._closest_ref(*args)
        assert (ik == ir).float().mean().item() >= 0.999
        both = (ik == ir) & (ir >= 0)
        torch.testing.assert_close(tk[both], tr[both], rtol=1e-4, atol=1e-5)
        assert (tr[both] < 0).any().item() == (tmin_v < 0)
        occ = rk.any_hit(*args)
        assert (occ == rk._anyhit_ref(*args)).float().mean().item() >= 0.999
        assert rk.LAUNCHES["closest"] == before["closest"] + 1
        assert rk.LAUNCHES["anyhit"] == before["anyhit"] + 1


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
        before = ck.LAUNCHES["cone_minz"]
        zc, cnt = ck.cone_minz(*args)
        zr, cr = ck._minz_ref(*args)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["cone_minz"] == before + 1
        finite = torch.isfinite(zr)
        assert finite.any().item()
        assert (torch.isfinite(zc) == finite).float().mean().item() > 0.999
        both = finite & torch.isfinite(zc)
        torch.testing.assert_close(zc[both], zr[both], rtol=2e-4, atol=2e-4)
        ok = (cnt - cr).abs() <= torch.clamp(0.02 * cr, min=2)
        assert ok.float().mean().item() > 0.97


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
