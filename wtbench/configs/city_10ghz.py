"""city_10ghz: a 10 GHz coverage map over a city of 14 × 14 concrete
blocks (2,354 triangles, 2,356 wedge edges), in place of the Étoile mesh.

`parts(cfg)` gives the frozen geometry from the numbers in
city_10ghz.json (numpy only: the plain reference reads it);
`scene(cfg, traffic)` dresses it with the program's scene-model classes.
"""

from __future__ import annotations

import math

import numpy as np

from wtbench import geometry

C_LIGHT = 299792458.0


def wavenumber(cfg):
    """k [rad/m] of the transmitter's line."""
    return 2.0 * math.pi * cfg["frequency_hz"] / C_LIGHT


def parts(cfg):
    """[Part] in shape order: the blocks row by row, then the ground."""
    b = cfg["blocks"]
    n, pitch, fp = b["count"], b["pitch"], b["footprint"]
    out = []
    for i in range(n):
        for j in range(n):
            x = (i - (n - 1) / 2) * pitch
            z = (j - (n - 1) / 2) * pitch
            h = b["heights"][i][j]
            out.append(geometry.cube(
                [fp, 0, 0, x, 0, h, 0, h / 2, 0, 0, fp, z, 0, 0, 0, 1]))
    g = cfg["ground"]
    out.append(geometry.square(g["length"], g["rows"]))
    return out


def scene(cfg, traffic):
    """The program's Scene of this configuration under `traffic`."""
    from wave_tracer_tpu_torch.bsdf.model import (Material, SpmBSDF,
                                                  SurfaceProfile)
    from wave_tracer_tpu_torch.emitter.model import PointEmitter
    from wave_tracer_tpu_torch.geometry.mesh import build_soup_from_corners
    from wave_tracer_tpu_torch.scene.model import (IntegratorConfig, Scene,
                                                   Shape)
    from wave_tracer_tpu_torch.sensor.perspective import lookat_matrix
    from wave_tracer_tpu_torch.sensor.response import Response
    from wave_tracer_tpu_torch.sensor.tonemap import Tonemap
    from wave_tracer_tpu_torch.sensor.virtual_plane import VirtualPlaneSensor
    from wave_tracer_tpu_torch.spectrum.ior import ITUComplexSpectrum
    from wave_tracer_tpu_torch.spectrum.spectra import DiscreteSpectrum

    k0 = wavenumber(cfg)
    m = cfg["material"]
    concrete = Material(bsdf=SpmBSDF(
        ior=ITUComplexSpectrum(m["itu"]),
        profile=SurfaceProfile(**m["profile"])), twosided=True,
        name=m["itu"])
    shapes = [Shape(build_soup_from_corners(p.corners, p.normals, p.uvs),
                    concrete) for p in parts(cfg)]
    tx = cfg["transmitter"]
    emitter = PointEmitter(
        spectrum=DiscreteSpectrum(np.array([k0]), np.array([tx["power"]])),
        position=np.array(tx["position"], np.float64))
    s = cfg["sensor"]
    res = traffic["resolution"]
    sensor = VirtualPlaneSensor(
        width=res, height=res, extent=tuple(s["extent"]),
        to_world=lookat_matrix(s["origin"], s["target"], up=s["up"]),
        samples=traffic["samples_per_frame"],
        response=Response(type="monochromatic",
                          spectrum=DiscreteSpectrum(np.array([k0]),
                                                    np.array([1.0])),
                          tonemap=Tonemap(type="dB", db_min=s["db_min"],
                                          db_max=s["db_max"])))
    return Scene(shapes=shapes, emitters=[emitter], sensors=[sensor],
                 integrator=IntegratorConfig(type=traffic["integrator"],
                                             max_depth=traffic["max_depth"],
                                             fsd=traffic["fsd"]))
