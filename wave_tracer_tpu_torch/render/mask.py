"""Sensor-visibility alpha masks.

Port of wave_tracer_tpu/render/mask.py: an alpha image of the share of
each pixel's jittered camera rays that reach scene geometry, written
beside a render (`<sensor>_mask.png`). The rays go through `trace.trace`,
K1 on the card; their jitter is drawn from the same Sobol streams as the
JAX mask's, keyed by (pixel, subsample), so the masks agree.
"""

from __future__ import annotations

import numpy as np
import torch

from wave_tracer_tpu_torch.accel import trace as trace_mod
from wave_tracer_tpu_torch.sampling import rng

BIG = 1e30


def render_mask(built, sensor, subsamples: int = 4, seed: int = 0,
                batch: int = 1 << 16) -> np.ndarray:
    """(H, W) alpha in [0,1]: the fraction of `subsamples` jittered rays
    per pixel that hit, traced on the device `built` lives on, `batch`
    pixels a launch."""
    geo = built.data.geo
    dev = built.device
    W, H = sensor.width, sensor.height
    npix = W * H
    base_key = rng.make_base_key(seed)
    out = np.zeros(npix, np.float32)
    for p0 in range(0, npix, batch):
        pix = torch.arange(p0, min(p0 + batch, npix), dtype=torch.int64,
                           device=dev)
        n = pix.shape[0]
        pxy = torch.stack([pix % W, pix // W], dim=-1)
        acc = torch.zeros((n,), dtype=torch.float32, device=dev)
        for s in range(subsamples):
            keys = rng.sample_key(base_key, pix, torch.full_like(pix, s))
            ro, rd, _ = sensor.generate_rays(
                pxy, rng.uniform(keys, rng.D_PIXEL_JITTER, 2))
            _, tri, _, _ = trace_mod.trace(
                geo, ro, rd,
                torch.full((n,), 1e-6, dtype=torch.float32, device=dev),
                torch.full((n,), BIG, dtype=torch.float32, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
            acc = acc + (tri >= 0).to(torch.float32)
        out[p0:p0 + n] = (acc / subsamples).cpu().numpy()
    return out.reshape(H, W)
