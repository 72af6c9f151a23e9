"""Procedural scenes built from code alone (no scene files needed).

`make_coverage_scene` is the port's copy of the JAX package's GHz
coverage test scene (tests/test_coverage.py::make_coverage_scene): a
10 GHz point transmitter 8 m up, an 8×6×8 m building of ITU-R P.2040
concrete (surface_spm with a fractal profile) and a 60 m concrete ground,
seen by a 50×50 m virtual-plane sensor 1 m above the ground with a
monochromatic response and a dB tonemap, rendered by plt_path at depth 4.

`make_box_scene` is the port's twin of the test scene
tests/test_render.py::make_box_scene of the JAX package: a 2 m diffuse box
open at +z (white floor, ceiling and back wall, red left and green right
walls) lit by a 5000 K blackbody area panel under the ceiling (or a point
light), seen by an sRGB pinhole camera. `icosphere=True` adds the
benchmark's scale case: a tessellation-192 icosphere of 81,920 triangles
with the white material, placed as bench.py places it.
"""

from __future__ import annotations

import math

import numpy as np

from wave_tracer_tpu_torch.bsdf.model import (DiffuseBSDF, Material,
                                              SpmBSDF, SurfaceProfile)
from wave_tracer_tpu_torch.core.transform import Transform
from wave_tracer_tpu_torch.emitter.model import AreaEmitter, PointEmitter
from wave_tracer_tpu_torch.geometry import mesh
from wave_tracer_tpu_torch.scene.model import IntegratorConfig, Scene, Shape
from wave_tracer_tpu_torch.sensor.perspective import (PerspectiveSensor,
                                                      lookat_matrix)
from wave_tracer_tpu_torch.sensor.response import Response
from wave_tracer_tpu_torch.sensor.tonemap import Tonemap
from wave_tracer_tpu_torch.sensor.virtual_plane import VirtualPlaneSensor
from wave_tracer_tpu_torch.spectrum.ior import C_LIGHT, ITUComplexSpectrum
from wave_tracer_tpu_torch.spectrum.spectra import (BlackbodySpectrum,
                                                    DiscreteSpectrum,
                                                    RGBSpectrum,
                                                    UniformSpectrum)
from wave_tracer_tpu_torch.texture.texture import ConstantSpectrumTexture


def make_box_scene(res=32, spp=8, emitter="area", icosphere=False):
    """A 2 m box open at +z with a light at the top."""
    white = Material(bsdf=DiffuseBSDF(
        reflectance=ConstantSpectrumTexture(UniformSpectrum(0.7, 1.0, 1e9))),
        name="white")
    red = Material(bsdf=DiffuseBSDF(
        reflectance=ConstantSpectrumTexture(RGBSpectrum((0.8, 0.1, 0.1)))),
        name="red")
    green = Material(bsdf=DiffuseBSDF(
        reflectance=ConstantSpectrumTexture(RGBSpectrum((0.1, 0.8, 0.1)))),
        name="green")

    L = 2.0
    shapes = [
        # floor (normal +y)
        Shape(mesh.rectangle(L, Transform.from_rows(
            [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0, 0, 0, 1])), white),
        # ceiling (normal -y)
        Shape(mesh.rectangle(L, Transform.from_rows(
            [1, 0, 0, 0, 0, 0, -1, L, 0, 1, 0, 0, 0, 0, 0, 1])), white),
        # back wall at z=-1 (normal +z)
        Shape(mesh.rectangle(L, Transform.from_rows(
            [1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, -1, 0, 0, 0, 1])), white),
        # left wall x=-1 (normal +x)
        Shape(mesh.rectangle(L, Transform.from_rows(
            [0, 0, 1, -1, 0, 1, 0, 1, -1, 0, 0, 0, 0, 0, 0, 1])), red),
        # right wall x=+1 (normal -x)
        Shape(mesh.rectangle(L, Transform.from_rows(
            [0, 0, -1, 1, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1])), green),
    ]
    emitters = []
    lamp_spec = BlackbodySpectrum(T=5000.0, scale=5e-13)
    if emitter == "area":
        lamp = AreaEmitter(spectrum=lamp_spec)
        # small panel slightly under the ceiling, facing down
        panel = mesh.rectangle(0.5, Transform.from_rows(
            [1, 0, 0, 0, 0, 0, -1, L - 0.01, 0, 1, 0, 0, 0, 0, 0, 1]))
        shapes.append(Shape(panel, Material(
            bsdf=DiffuseBSDF(reflectance=ConstantSpectrumTexture(
                UniformSpectrum(0.1, 1.0, 1e9)))), emitter=lamp))
        emitters.append(lamp)
    else:
        emitters.append(PointEmitter(spectrum=lamp_spec,
                                     position=np.array([0.0, 1.8, 0.0])))
    if icosphere:
        shapes.append(Shape(mesh.sphere([2.78, 1.2, 2.78], 0.9,
                                        tessellation=192), white))

    sensor = PerspectiveSensor(
        width=res, height=res, fov=math.radians(60.0),
        to_world=lookat_matrix([0, 1.0, 3.2], [0, 1.0, 0]),
        samples=spp, response=Response(type="RGB", colourspace="sRGB",
                                       white_point="D65"))
    return Scene(shapes=shapes, emitters=emitters, sensors=[sensor],
                 integrator=IntegratorConfig(max_depth=5))


def make_coverage_scene(res=64):
    """A street-canyon coverage map at 10 GHz: res×res sensing elements
    over 50×50 m, 8 samples per element."""
    k0 = 2 * np.pi / (C_LIGHT / 10e9)       # 10 GHz → λ = 3 cm
    concrete = Material(
        bsdf=SpmBSDF(ior=ITUComplexSpectrum("concrete"),
                     profile=SurfaceProfile(type="fractal", gamma=3.0,
                                            T=400.0, sigma=0.02)),
        twosided=True, name="concrete")
    # a building slab between the transmitter and half the map
    building = Shape(mesh.cube(1.0, Transform.from_rows(
        [8, 0, 0, 0, 0, 6, 0, 3, 0, 0, 8, -10, 0, 0, 0, 1])), concrete)
    ground = Shape(mesh.rectangle(60.0, Transform.from_rows(
        [1, 0, 0, 0, 0, 0, 1, -0.01, 0, -1, 0, 0, 0, 0, 0, 1])), concrete)
    tx = PointEmitter(
        spectrum=DiscreteSpectrum(np.array([k0]), np.array([100.0])),
        position=np.array([0.0, 8.0, 10.0]))
    sensor = VirtualPlaneSensor(
        width=res, height=res, extent=(50.0, 50.0),
        # the plane faces the transmitter (sensing accepts cos_in > 0)
        to_world=lookat_matrix([0, 1.0, 0], [0, 10.0, 0], up=[0, 0, 1]),
        samples=8,
        response=Response(type="monochromatic",
                          spectrum=DiscreteSpectrum(np.array([k0]),
                                                    np.array([1.0])),
                          tonemap=Tonemap(type="dB", db_min=-120,
                                          db_max=-40)))
    return Scene(shapes=[building, ground], emitters=[tx],
                 sensors=[sensor],
                 integrator=IntegratorConfig(type="plt_path", max_depth=4))
