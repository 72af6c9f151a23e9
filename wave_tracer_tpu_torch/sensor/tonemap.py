"""Tonemap operators: linear / gamma / sRGB / dB, with optional colormaps.

Port of wave_tracer_tpu/sensor/tonemap.py (reference
include/wt/sensor/response/tonemap/tonemap.hpp:38-80, tonemap.cpp:43-92).
Tonemapping is host-side post-processing (numpy) applied
to developed films before PNG output; the dB operator with Turbo colormap is
what coverage-map scenes use (scenes/sionna_etoile, double_slits).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Tonemap:
    type: str = "linear"          # linear | gamma | sRGB | dB
    gamma: float = 2.2
    db_min: float = -40.0
    db_max: float = 0.0
    colourmap: Optional[str] = None   # Turbo | Magma | Viridis | ...
    scale: float = 1.0

    def apply(self, img: np.ndarray) -> np.ndarray:
        """Map a linear image (H, W, C) to display [0,1] (H, W, 3)."""
        v = np.asarray(img, np.float64) * self.scale
        if self.type == "linear":
            out = v
        elif self.type == "gamma":
            out = np.power(np.maximum(v, 0.0), 1.0 / self.gamma)
        elif self.type == "sRGB":
            out = srgb_encode(v)
        elif self.type == "dB":
            inten = v[..., 0] if v.ndim == 3 else v
            db = 10.0 * np.log10(np.maximum(inten, 1e-30))
            out = (db - self.db_min) / max(self.db_max - self.db_min, 1e-9)
            out = out[..., None]
        else:
            raise ValueError(self.type)
        out = np.clip(out, 0.0, 1.0)
        if self.colourmap or (out.shape[-1] == 1 and self.type == "dB"):
            t = out[..., 0]
            out = apply_colourmap(t, self.colourmap or "Turbo")
        elif out.shape[-1] == 1:
            out = np.repeat(out, 3, axis=-1)
        return out


def srgb_encode(v: np.ndarray) -> np.ndarray:
    v = np.maximum(v, 0.0)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.power(v, 1.0 / 2.4) - 0.055)


# Turbo colormap polynomial fit (Google AI blog 2019, Apache-2.0 published
# coefficients; same map the reference gets from tinycolormap).
_TURBO_R = [0.13572138, 4.61539260, -42.66032258, 132.13108234,
            -152.94239396, 59.28637943]
_TURBO_G = [0.09140261, 2.19418839, 4.84296658, -14.18503333,
            4.27729857, 2.82956604]
_TURBO_B = [0.10667330, 12.64194608, -60.58204836, 110.36276771,
            -89.90310912, 27.34824973]


def _polyval(coeffs, x):
    out = np.zeros_like(x)
    for i, c in enumerate(coeffs):
        out = out + c * x ** i
    return out


def turbo(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return np.clip(np.stack([_polyval(_TURBO_R, t), _polyval(_TURBO_G, t),
                             _polyval(_TURBO_B, t)], axis=-1), 0.0, 1.0)


def apply_colourmap(t: np.ndarray, name: str) -> np.ndarray:
    name_l = name.lower()
    if name_l == "turbo":
        return turbo(t)
    # Other maps via matplotlib's registry.
    try:
        import matplotlib
        cmap = matplotlib.colormaps[name_l]
        return np.asarray(cmap(np.clip(t, 0, 1)))[..., :3]
    except Exception:
        return turbo(t)
