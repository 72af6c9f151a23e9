"""Procedural scenes built from code alone (no scene files needed).

`make_coverage_scene` is the port's copy of the JAX package's GHz
coverage test scene (tests/test_coverage.py::make_coverage_scene): a
10 GHz point transmitter 8 m up, an 8×6×8 m building of ITU-R P.2040
concrete (surface_spm with a fractal profile) and a 60 m concrete ground,
seen by a 50×50 m virtual-plane sensor 1 m above the ground with a
monochromatic response and a dB tonemap, rendered by plt_path at depth 4.

`make_city_coverage_scene` grows that canyon into a city: a grid of
blocks × blocks box buildings of the same concrete (8×8 m footprints on
a 12 m grid, seeded heights of 4-12 m) on a concrete ground, a 10 GHz
transmitter 20 m above the central crossing, and a virtual-plane sensor
1 m above the ground over the whole grid. At 14 × 14 blocks it holds
2,354 triangles and 2,356 classified wedge edges, above the 2,048 where
the integrators take the clustered edge sweep.

`make_box_scene` is the port's twin of the test scene
tests/test_render.py::make_box_scene of the JAX package: a 2 m diffuse box
open at +z (white floor, ceiling and back wall, red left and green right
walls) lit by a 5000 K blackbody area panel under the ceiling (or a point
light), seen by an sRGB pinhole camera. `icosphere=True` adds the
benchmark's scale case: a tessellation-192 icosphere of 81,920 triangles
with the white material, placed as bench.py places it (`tessellation`
another subdivision: 384 gives 327,680 triangles, above MXU_MAX_TRIS).

`make_materials_box_scene` is that box with every material, texture and
emitter type of the backward integrators in it (10,254 triangles): a
glass sphere and a rough-conductor (surface_spm) sphere of 5,120
triangles each, a seeded 256×256 bitmap on the back wall, a checkerboard
floor, a composite right wall (a normal-mapped diffuse child over the
long visible wavelengths, a rough-conductor child over the short ones),
a masked panel with a checkerboard opacity, and a spot light with a
piecewise-linear spectrum aimed at the glass sphere.

`slit_screen_xml` writes a double slit as scene XML (both packages'
loaders read it): three strips leave two 0.35 mm slits, lit at 500 nm
by a spot on the axis, seen by a virtual-plane sensor 1 m behind.
"""

from __future__ import annotations

import math

import numpy as np

from wave_tracer_tpu_torch.bsdf.model import (CompositeBSDF, DielectricBSDF,
                                              DiffuseBSDF, Material,
                                              SpmBSDF, SurfaceProfile)
from wave_tracer_tpu_torch.core.transform import Transform
from wave_tracer_tpu_torch.emitter.model import (AreaEmitter, PointEmitter,
                                                 SpotEmitter)
from wave_tracer_tpu_torch.geometry import mesh
from wave_tracer_tpu_torch.scene.model import IntegratorConfig, Scene, Shape
from wave_tracer_tpu_torch.sensor.perspective import (PerspectiveSensor,
                                                      lookat_matrix)
from wave_tracer_tpu_torch.sensor.response import Response
from wave_tracer_tpu_torch.sensor.tonemap import Tonemap
from wave_tracer_tpu_torch.sensor.virtual_plane import VirtualPlaneSensor
from wave_tracer_tpu_torch.spectrum.ior import C_LIGHT, ITUComplexSpectrum
from wave_tracer_tpu_torch.spectrum.spectra import (
    K_VISIBLE_MAX, K_VISIBLE_MIN, BlackbodySpectrum, ComplexUniformSpectrum,
    DiscreteSpectrum, PiecewiseLinearSpectrum, RGBSpectrum, UniformSpectrum)
from wave_tracer_tpu_torch.texture.texture import (BitmapTexture,
                                                   CheckerboardTexture,
                                                   ConstantRGBTexture,
                                                   ConstantSpectrumTexture)


def make_box_scene(res=32, spp=8, emitter="area", icosphere=False,
                   tessellation=192):
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
                                        tessellation=tessellation), white))

    sensor = PerspectiveSensor(
        width=res, height=res, fov=math.radians(60.0),
        to_world=lookat_matrix([0, 1.0, 3.2], [0, 1.0, 0]),
        samples=spp, response=Response(type="RGB", colourspace="sRGB",
                                       white_point="D65"))
    return Scene(shapes=shapes, emitters=emitters, sensors=[sensor],
                 integrator=IntegratorConfig(max_depth=5))


# the box's walls: (to_world rows, material id) in make_box_scene's order
_BOX_WALLS = (
    ([1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0, 0, 0, 1], "white"),
    ([1, 0, 0, 0, 0, 0, -1, 2, 0, 1, 0, 0, 0, 0, 0, 1], "white"),
    ([1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, -1, 0, 0, 0, 1], "white"),
    ([0, 0, 1, -1, 0, 1, 0, 1, -1, 0, 0, 0, 0, 0, 0, 1], "red"),
    ([0, 0, -1, 1, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1], "green"))


def box_scene_xml(res=32, spp=8, max_depth=5, fsd=True, emitter="area",
                  icosphere=False) -> str:
    """`make_box_scene(res, spp, emitter, icosphere)` with plt_path at the
    given max_depth and FSD as scene XML text (`res` and `spp` are
    defaults, so `-D res=...,spp=...` overrides them). Matrices are
    written with repr floats, so the file loads to the same numbers."""
    def matrix(rows):
        return ", ".join(repr(float(v)) for v in np.ravel(rows))

    blackbody = ('<spectrum blackbody="5000K"><float name="scale" '
                 'value="5e-13"/></spectrum>')
    out = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<scene version="0.1">',
        f'  <default name="res" value="{int(res)}"/>',
        f'  <default name="spp" value="{int(spp)}"/>',
        '  <integrator type="plt_path">',
        f'    <integer name="max_depth" value="{int(max_depth)}"/>',
        f'    <boolean name="FSD" value="{"true" if fsd else "false"}"/>',
        '  </integrator>',
        '  <sensor type="perspective" id="camera">',
        '    <quantity name="fov" value="60°"/>',
        '    <integer name="samples" value="$spp"/>',
        '    <transform name="to_world"><matrix value="'
        + matrix(lookat_matrix([0, 1.0, 3.2], [0, 1.0, 0]))
        + '"/></transform>',
        '    <film><integer name="width" value="$res"/>'
        '<integer name="height" value="$res"/>'
        '<response type="RGB"/></film>',
        '  </sensor>',
        '  <bsdf type="diffuse" id="white"><spectrum name="reflectance" '
        'value="0.7"/></bsdf>',
        '  <bsdf type="diffuse" id="red"><spectrum name="reflectance" '
        'rgb="0.8, 0.1, 0.1"/></bsdf>',
        '  <bsdf type="diffuse" id="green"><spectrum name="reflectance" '
        'rgb="0.1, 0.8, 0.1"/></bsdf>']
    for rows, mat in _BOX_WALLS:
        out += ['  <shape type="rectangle"><float name="length" value="2"/>'
                f'<transform name="to_world"><matrix value="{matrix(rows)}"/>'
                f'</transform><ref id="{mat}"/></shape>']
    if emitter == "area":
        out += ['  <shape type="rectangle" id="lamp"><float name="length" '
                'value="0.5"/><transform name="to_world"><matrix value="'
                + matrix([1, 0, 0, 0, 0, 0, -1, 2.0 - 0.01, 0, 1, 0, 0, 0, 0, 0, 1])
                + '"/></transform><bsdf type="diffuse"><spectrum '
                'name="reflectance" value="0.1"/></bsdf>'
                f'<emitter type="area">{blackbody}</emitter></shape>']
    else:
        out += ['  <emitter type="point"><point name="position" '
                f'value="0, 1.8, 0"/>{blackbody}</emitter>']
    if icosphere:
        out += ['  <shape type="sphere" id="icosphere"><point name="center" '
                'value="2.78, 1.2, 2.78"/><float name="radius" value="0.9"/>'
                '<integer name="tessellation" value="192"/>'
                '<ref id="white"/></shape>']
    return "\n".join(out + ["</scene>", ""])


SLIT_SCREEN = dict(
    slit=0.35e-3,          # each slit's width (m)
    strip=1.0e-3,          # the central strip's width
    outer=10.0e-3,         # each outer strip's width
    height=40.0e-3,        # every strip's height: edges at y = ±20 mm
    source=0.5,            # emitter distance in front of the screen
    throw=1.0,             # sensor distance behind the screen
    extent=20.0e-3,        # the sensor's side
    wavelength="500nm",
    cutoff=0.6,            # the spot's cutoff angle (degrees)
)


def slit_screen_xml(res=64, spp=2, max_depth=4) -> str:
    """A double slit as scene XML text: three `rectangle` strips in the
    z = 0 plane (facing +z; shapes 0, 1, 2 = left, central, right) leave
    two slits of SLIT_SCREEN["slit"] either side of a central strip; a
    monochromatic spot emitter on the axis in front of the screen, its
    cone just covering the slits, lights them; a `virtual_plane` sensor
    behind it records the fringes; plt_bdpt, so a render runs forward
    transport with the Fraunhofer interaction. `res` and `spp` are
    defaults (`-D res=...,spp=...`)."""
    g = SLIT_SCREEN

    def matrix(rows):
        return ", ".join(repr(float(v)) for v in np.ravel(rows))

    half_in = 0.5 * g["strip"]
    half_out = half_in + g["slit"]
    strips = ((-(half_out + 0.5 * g["outer"]), g["outer"]),
              (0.0, g["strip"]),
              (half_out + 0.5 * g["outer"], g["outer"]))
    spectrum = (f'<spectrum type="discrete" wavelength="{g["wavelength"]}" '
                'value="1"/>')
    cut = math.radians(g["cutoff"])
    out = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<scene version="0.1">',
        f'  <default name="res" value="{int(res)}"/>',
        f'  <default name="spp" value="{int(spp)}"/>',
        '  <integrator type="plt_bdpt">',
        f'    <integer name="max_depth" value="{int(max_depth)}"/>',
        '  </integrator>',
        '  <sensor type="virtual_plane" id="fringes">',
        f'    <float name="extent" value="{g["extent"]!r}"/>',
        '    <integer name="samples" value="$spp"/>',
        '    <transform name="to_world"><matrix value="'
        + matrix(lookat_matrix([0, 0, -g["throw"]], [0, 0, 0]))
        + '"/></transform>',
        '    <film><integer name="width" value="$res"/>'
        '<integer name="height" value="$res"/>'
        f'<response type="monochromatic">{spectrum}</response></film>',
        '  </sensor>',
        '  <bsdf type="diffuse" id="screen"><spectrum name="reflectance" '
        'value="0.5"/></bsdf>']
    for cx, w in strips:
        out += ['  <shape type="rectangle"><float name="length" value="1"/>'
                '<transform name="to_world"><matrix value="'
                + matrix([w, 0, 0, cx, 0, g["height"], 0, 0, 0, 0, 1, 0,
                          0, 0, 0, 1])
                + '"/></transform><ref id="screen"/></shape>']
    out += ['  <emitter type="spot">'
            f'<float name="beam_width" value="{0.8 * cut!r}"/>'
            f'<float name="cutoff_angle" value="{cut!r}"/>'
            '<transform name="to_world"><matrix value="'
            + matrix(lookat_matrix([0, 0, g["source"]], [0, 0, 0]))
            + f'"/></transform>{spectrum}</emitter>']
    return "\n".join(out + ["</scene>", ""])


def make_materials_box_scene(res=32, spp=8, seed=7):
    """The box of `make_box_scene` with glass, a rough conductor, bitmap,
    checkerboard, composite, normal-mapped and masked surfaces and a spot
    light (module doc). `seed` makes the bitmap and the normal map."""
    scene = make_box_scene(res=res, spp=spp)
    floor, _, back, _, right = scene.shapes[:5]
    rng = np.random.default_rng(seed)
    floor.material = Material(bsdf=DiffuseBSDF(reflectance=CheckerboardTexture(
        rgb_a=(0.8, 0.8, 0.8), rgb_b=(0.2, 0.2, 0.2), uv_scale=(8.0, 8.0))),
        name="checker")
    back.material = Material(bsdf=DiffuseBSDF(reflectance=BitmapTexture(
        data=rng.uniform(0.1, 0.9, (256, 256, 3)).astype(np.float32))),
        name="bitmap")
    # tangent-space normals tilted up to ~17° off the surface normal
    nmap = np.concatenate([rng.uniform(0.35, 0.65, (64, 64, 2)),
                           np.ones((64, 64, 1))], axis=-1)
    conductor = SpmBSDF(
        ior=ComplexUniformSpectrum(0.27 + 2.9j),
        profile=SurfaceProfile(type="gaussian", roughness=(
            ConstantSpectrumTexture(UniformSpectrum(0.3, 1.0, 1e9)))))
    k_mid = 2 * math.pi / 550e-9
    right.material = Material(bsdf=CompositeBSDF(bins=[
        (K_VISIBLE_MIN, k_mid, Material(
            bsdf=DiffuseBSDF(reflectance=ConstantRGBTexture((0.1, 0.7, 0.2))),
            normalmap=BitmapTexture(data=nmap.astype(np.float32)),
            name="green_bumpy")),
        (k_mid, K_VISIBLE_MAX, Material(bsdf=conductor, twosided=True,
                                        name="rough_metal"))]),
        name="composite")
    scene.shapes += [
        # glass sphere under the lamp, rough-conductor sphere on the left
        Shape(mesh.sphere([0.35, 0.45, 0.1], 0.42, tessellation=48),
              Material(bsdf=DielectricBSDF(ior=ComplexUniformSpectrum(1.5)),
                       name="glass")),
        Shape(mesh.sphere([-0.5, 0.35, -0.45], 0.34, tessellation=48),
              Material(bsdf=conductor, name="rough_metal_sphere")),
        # a 0.6 m panel facing the camera, half its checker cells cut out
        Shape(mesh.rectangle(0.6, Transform.from_rows(
            [1, 0, 0, -0.45, 0, 1, 0, 1.25, 0, 0, 1, 0.3, 0, 0, 0, 1])),
            Material(bsdf=DiffuseBSDF(reflectance=ConstantRGBTexture(
                (0.6, 0.5, 0.3))), twosided=True,
                opacity=CheckerboardTexture(
                    rgb_a=(1.0, 1.0, 1.0), rgb_b=(0.0, 0.0, 0.0),
                    uv_scale=(4.0, 4.0)), name="masked"))]
    k_nodes = 2 * math.pi / np.array([700e-9, 600e-9, 500e-9, 400e-9])
    src, dst = np.array([-0.6, 1.75, 0.7]), np.array([0.35, 0.45, 0.1])
    scene.emitters.append(SpotEmitter(
        spectrum=PiecewiseLinearSpectrum(k_nodes,
                                         np.array([1.0, 3.0, 2.0, 0.5]) * 2e-13),
        position=src, direction=(dst - src) / np.linalg.norm(dst - src),
        beam_width=math.radians(12.0), cutoff=math.radians(20.0)))
    return scene


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


def make_city_coverage_scene(res=64, blocks=14, seed=5):
    """A city coverage map at 10 GHz: blocks × blocks concrete buildings
    on a 12 m grid, res×res sensing elements over the grid, 8 samples per
    element (see the module doc)."""
    k0 = 2 * np.pi / (C_LIGHT / 10e9)
    concrete = Material(
        bsdf=SpmBSDF(ior=ITUComplexSpectrum("concrete"),
                     profile=SurfaceProfile(type="fractal", gamma=3.0,
                                            T=400.0, sigma=0.02)),
        twosided=True, name="concrete")
    pitch = 12.0
    span = blocks * pitch
    heights = np.random.default_rng(seed).uniform(4.0, 12.0, (blocks, blocks))
    shapes = []
    for i in range(blocks):
        for j in range(blocks):
            x = (i - (blocks - 1) / 2) * pitch
            z = (j - (blocks - 1) / 2) * pitch
            h = heights[i, j]
            shapes.append(Shape(mesh.cube(1.0, Transform.from_rows(
                [8, 0, 0, x, 0, h, 0, h / 2, 0, 0, 8, z, 0, 0, 0, 1])),
                concrete))
    shapes.append(Shape(mesh.rectangle(span + 20.0, Transform.from_rows(
        [1, 0, 0, 0, 0, 0, 1, -0.01, 0, -1, 0, 0, 0, 0, 0, 1])), concrete))
    tx = PointEmitter(
        spectrum=DiscreteSpectrum(np.array([k0]), np.array([100.0])),
        position=np.array([0.0, 20.0, 0.0]))
    sensor = VirtualPlaneSensor(
        width=res, height=res, extent=(span, span),
        to_world=lookat_matrix([0, 1.0, 0], [0, 10.0, 0], up=[0, 0, 1]),
        samples=8,
        response=Response(type="monochromatic",
                          spectrum=DiscreteSpectrum(np.array([k0]),
                                                    np.array([1.0])),
                          tonemap=Tonemap(type="dB", db_min=-140,
                                          db_max=-40)))
    return Scene(shapes=shapes, emitters=[tx], sensors=[sensor],
                 integrator=IntegratorConfig(type="plt_path", max_depth=4))
