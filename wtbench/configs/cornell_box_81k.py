"""cornell_box_81k: the wave-optical Cornell box with an 81,920-triangle
icosphere in place of its dragon (81,932 triangles).

`parts(cfg)` gives the frozen geometry from the numbers in
cornell_box_81k.json (numpy only: the plain reference reads it);
`scene(cfg, traffic)` dresses it with the program's scene-model classes.
"""

from __future__ import annotations

import math

from wtbench import geometry


def parts(cfg):
    """[(Part, material name, is the lamp)] in shape order."""
    walls = cfg["walls"]
    out = [(geometry.square(walls["length"], w["rows"]), w["material"], False)
           for w in walls["shapes"]]
    lamp = cfg["lamp"]
    out.append((geometry.square(lamp["length"], lamp["rows"]), None, True))
    ico = cfg["icosphere"]
    out.append((geometry.icosphere(ico["center"], ico["radius"],
                                   ico["subdivisions"]), ico["material"],
                False))
    return out


def scene(cfg, traffic):
    """The program's Scene of this configuration under `traffic`."""
    from wave_tracer_tpu_torch.bsdf.model import DiffuseBSDF, Material
    from wave_tracer_tpu_torch.emitter.model import AreaEmitter
    from wave_tracer_tpu_torch.geometry.mesh import build_soup_from_corners
    from wave_tracer_tpu_torch.scene.model import (IntegratorConfig, Scene,
                                                   Shape)
    from wave_tracer_tpu_torch.sensor.perspective import (PerspectiveSensor,
                                                          lookat_matrix)
    from wave_tracer_tpu_torch.sensor.response import Response
    from wave_tracer_tpu_torch.spectrum.spectra import (BlackbodySpectrum,
                                                        RGBSpectrum,
                                                        UniformSpectrum)
    from wave_tracer_tpu_torch.texture.texture import ConstantSpectrumTexture

    def spectrum(m):
        if "uniform" in m:
            return UniformSpectrum(m["uniform"], 1.0, 1e9)
        return RGBSpectrum(tuple(m["rgb"]))

    materials = {name: Material(bsdf=DiffuseBSDF(
        reflectance=ConstantSpectrumTexture(spectrum(m))), name=name)
        for name, m in cfg["materials"].items()}
    lamp_cfg = cfg["lamp"]
    lamp = AreaEmitter(spectrum=BlackbodySpectrum(
        T=lamp_cfg["blackbody_K"], scale=lamp_cfg["scale"]))
    shapes = []
    for part, mat, is_lamp in parts(cfg):
        soup = build_soup_from_corners(part.corners, part.normals, part.uvs)
        if is_lamp:
            shapes.append(Shape(soup, Material(bsdf=DiffuseBSDF(
                reflectance=ConstantSpectrumTexture(UniformSpectrum(
                    lamp_cfg["reflectance"], 1.0, 1e9)))), emitter=lamp))
        else:
            shapes.append(Shape(soup, materials[mat]))
    cam = cfg["camera"]
    res = traffic["resolution"]
    sensor = PerspectiveSensor(
        width=res, height=res, fov=math.radians(cam["fov_deg"]),
        to_world=lookat_matrix(cam["origin"], cam["target"]),
        samples=traffic["samples_per_frame"],
        response=Response(type="RGB", colourspace="sRGB", white_point="D65"))
    return Scene(shapes=shapes, emitters=[lamp], sensors=[sensor],
                 integrator=IntegratorConfig(type=traffic["integrator"],
                                             max_depth=traffic["max_depth"],
                                             fsd=traffic["fsd"]))
