"""K1/K2 and the classical render on a CUDA card against the plain torch
twins. Marked `gpu`: each test skips without a card. This file imports no
jax, so it also runs on GPU hosts without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from wave_tracer_tpu_torch.accel import ray_kernels as rk
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
