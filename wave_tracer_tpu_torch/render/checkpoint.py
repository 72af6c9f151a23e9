"""Render checkpoint and resume: the raw film and the sampling cursor.

Port of wave_tracer_tpu/render/checkpoint.py, with the same `.npz` keys
and FORMAT_VERSION, so a checkpoint written by either package loads in
the other. Every path's random streams are keyed by (pixel, sample), so
continuing a render from spp_done with the saved film reproduces the
remaining samples exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from wave_tracer_tpu_torch.sensor.film import Film

FORMAT_VERSION = 1


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_checkpoint(path: str, film: Film, spp_done, seed: int,
                    sensor_id: str = ""):
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        value=_host(film.value),
        weight=_host(film.weight),
        direct=_host(film.direct),
        rfilter_sigma=film.rfilter_sigma,
        radius=film.radius,
        spp_done=spp_done,
        seed=seed,
        sensor_id=sensor_id)


def load_checkpoint(path: str, device="cpu"):
    """Returns (film on `device`, spp_done, seed, sensor_id)."""
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {z['version']}")
    film = Film(value=torch.as_tensor(z["value"], device=device),
                weight=torch.as_tensor(z["weight"], device=device),
                direct=torch.as_tensor(z["direct"], device=device),
                rfilter_sigma=float(z["rfilter_sigma"]),
                radius=int(z["radius"]))
    return film, int(z["spp_done"]), int(z["seed"]), str(z["sensor_id"])
