"""Port parity for the scene-file frontend: quantities, transforms, OBJ and
PLY meshes, the procedural shapes, the colourimetry and data-file helpers,
and the XML loader, each fed the same input as the JAX package.

* quantities, transforms, meshes, CIE matrices: equal bit for bit (both
  packages compute them in float64 numpy);
* OBJ / PLY: equal arrays from files in ASCII and both binary byte orders,
  with and without normals and uvs;
* one inline scene that uses every element the loader handles (but the
  data-file spectra): the port's bake equals the JAX bake key for key,
  triangle-indexed keys through the JAX BVH order, as in
  tests/test_torch_bake.py;
* the benchmark box written as XML (`box_scene_xml`): the port's bake of
  the file equals its bake of `make_box_scene` (the two uniform spectra's
  grid ranges excepted: the dialect's uniform spectrum spans other
  wavenumbers than the procedural box's; their values are equal), and
  the file rendered at 16×16, depth 3 by the JAX package and by the port
  (the JAX bake bridged, the port's loader giving sensor and integrator)
  agrees under PERF.md §2's classical bars with FSD off and its wave bars
  with FSD on."""

import dataclasses
import math
import os
import struct

import numpy as np
import pytest

from test_torch_bake import (TRI_KEYS, _canonical_edges, _emitter_tris,
                             _flatten)
from test_torch_threads import cap_torch_threads
from wave_tracer_tpu.core import quantity as jq
from wave_tracer_tpu.core import transform as jtf
from wave_tracer_tpu.geometry import mesh as jmesh
from wave_tracer_tpu.geometry import obj as jobj
from wave_tracer_tpu.geometry import ply as jply
from wave_tracer_tpu.render import render_scene as jrender
from wave_tracer_tpu.scene import build_scene as jbuild
from wave_tracer_tpu.scene import xml as jxml
from wave_tracer_tpu.sensor import response as jresp
from wave_tracer_tpu.spectrum import cie as jcie
from wave_tracer_tpu.spectrum import ior as jior
from wave_tracer_tpu_torch.core import quantity as tq
from wave_tracer_tpu_torch.core import transform as ttf
from wave_tracer_tpu_torch.geometry import mesh as tmesh
from wave_tracer_tpu_torch.geometry import obj as tobj
from wave_tracer_tpu_torch.geometry import ply as tply
from wave_tracer_tpu_torch.render import render_scene
from wave_tracer_tpu_torch.render.output import encode_png
from wave_tracer_tpu_torch.scene import bridge
from wave_tracer_tpu_torch.scene import xml as txml
from wave_tracer_tpu_torch.scene.build import BuiltScene, bake_scene_arrays
from wave_tracer_tpu_torch.scene.procedural import (box_scene_xml,
                                                    make_box_scene)
from wave_tracer_tpu_torch.sensor import response as tresp
from wave_tracer_tpu_torch.spectrum import cie as tcie
from wave_tracer_tpu_torch.spectrum import ior as tior

cap_torch_threads()

# ---------------------------------------------------------------------------
# quantities and transforms
# ---------------------------------------------------------------------------

QUANTITIES = ["2cm", ".05mm", "400nm", "1.5m", "19.75°", "1rad", "3 mrad",
              "10GHz", "2.4 MHz", "(250/4) mm", "7000K", "-18", "1e-3 s",
              "5 µm", "(2*25)°", "+.5km"]


@pytest.mark.parametrize("s", QUANTITIES)
def test_parse_quantity_matches_jax(s):
    a, b = tq.parse_quantity(s), jq.parse_quantity(s)
    assert (a.value, a.dim) == (b.value, b.dim)
    if a.dim in ("length", "frequency"):
        assert tq.wavelength_m(a) == jq.wavelength_m(b)
        assert tq.wavenumber_from_wavelength_m(tq.wavelength_m(a)) == \
            jq.wavenumber_from_wavelength_m(jq.wavelength_m(b))


@pytest.mark.parametrize("s", ["(1,100i)", "1.5", "(0.27, 2.9i)",
                               "( -1e-3 , 4.5e2i )", "(3/2)"])
def test_parse_complex_matches_jax(s):
    assert tq.parse_complex(s) == jq.parse_complex(s)


def test_vectors_ranges_and_errors_match_jax():
    for s in ["0cm, 1cm, 6.8cm", "(1+1)m, 2, 3°", "1,2"]:
        assert [(q.value, q.dim) for q in tq.parse_quantity_vector(s)] == \
            [(q.value, q.dim) for q in jq.parse_quantity_vector(s)]
    for s in ["300nm .. 800nm", "-18 .. 25", "(1+2) .. 4GHz"]:
        a, b = tq.parse_range(s), jq.parse_range(s)
        assert [(q.value, q.dim) for q in a] == [(q.value, q.dim) for q in b]
    for bad in ["", "3 parsecs", "(1+2", "abc"]:
        with pytest.raises(tq.QuantityError):
            tq.parse_quantity(bad)
        with pytest.raises(jq.QuantityError):
            jq.parse_quantity(bad)
    with pytest.raises(tq.QuantityError):
        tq.parse_range("1..2..3")
    with pytest.raises(tq.QuantityError):
        tq.wavelength_m(tq.parse_quantity("3°"))


def _transforms(tf):
    """The cases of tests/test_core.py's TestTransform and more."""
    T = tf.Transform
    return {
        "lookat_up": T.lookat([0, 1, 6.8], [0, 1, 0], [0, 1, 0]),
        "lookat_default_up": T.lookat([1, 2, 3], [-4, 0, 2]),
        "lookat_y": T.lookat([0, 5, 0], [0.1, 0, 0.2]),
        "compose": T.translate([5, 0, 0]) @ T.rotate([0, 0, 1], math.pi / 2),
        "rotate": T.rotate([0.3, -1.0, 0.4], 1.234),
        "scale": T.scale([2, 1, 1]) @ T.scale(0.5),
        "inverse": (T.translate([1, -2, 3]) @ T.rotate([1, 1, 0], 0.7)
                    @ T.scale([1, 2, 3])).inverse,
        "rows": T.from_rows(np.arange(16.0) % 5 + np.eye(4).ravel()),
    }


@pytest.mark.parametrize("name", list(_transforms(ttf)))
def test_transform_matches_jax(name):
    a, b = _transforms(ttf)[name], _transforms(jtf)[name]
    np.testing.assert_array_equal(a.m, b.m)
    np.testing.assert_array_equal(a.linear, b.linear)
    p = np.array([[1.0, 0.0, 0.0], [0.3, -2.0, 5.0]])
    for f in ("apply_point", "apply_vector", "apply_normal"):
        np.testing.assert_array_equal(getattr(a, f)(p), getattr(b, f)(p))
    n = np.array([0.3, -0.5, 0.81])
    n /= np.linalg.norm(n)
    np.testing.assert_array_equal(ttf._orthogonal_tangent(n),
                                  jtf._orthogonal_tangent(n))


def test_lookat_maps_z_to_view_direction():
    t = ttf.Transform.lookat([0, 1, 6.8], [0, 1, 0], [0, 1, 0])
    np.testing.assert_allclose(t.apply_vector([0, 0, 1]), [0, 0, -1],
                               atol=1e-12)
    np.testing.assert_allclose(t.apply_point([0, 0, 0]), [0, 1, 6.8])
    R = ttf.Transform.lookat([1, 2, 3], [-4, 0, 2], [0, 1, 0]).linear
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-12)


# ---------------------------------------------------------------------------
# OBJ and PLY files
# ---------------------------------------------------------------------------

_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]],
              np.float64) + np.array([0.125, -0.25, 0.5])
_F = [[0, 1, 2, 3], [0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]]


def _write_ply(path, fmt, normals, uvs, uv_names=("u", "v")):
    n = _V - _V.mean(0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    props = [("x", "float"), ("y", "float"), ("z", "float")]
    cols = [_V]
    if normals:
        props += [("nx", "float"), ("ny", "float"), ("nz", "float")]
        cols.append(n)
    if uvs:
        props += [(uv_names[0], "float"), (uv_names[1], "float")]
        cols.append(_V[:, :2] * 0.5)
    props.append(("red", "uchar"))
    cols.append(np.arange(len(_V))[:, None] * 40.0)
    rows = np.concatenate(cols, axis=1)
    head = [f"format {fmt} 1.0", "comment test mesh",
            f"element vertex {len(_V)}"]
    head += [f"property {t} {p}" for p, t in props]
    head += [f"element face {len(_F)}",
             "property list uchar int vertex_indices", "end_header"]
    text = "ply\n" + "\n".join(head) + "\n"
    if fmt == "ascii":
        body = "".join(" ".join(repr(float(x)) if t == "float" else str(int(x))
                                for x, (_, t) in zip(r, props)) + "\n"
                       for r in rows)
        body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n"
                        for f in _F)
        data = (text + body).encode()
    else:
        e = "<" if fmt == "binary_little_endian" else ">"
        body = b"".join(b"".join(struct.pack(e + "f", x) if t == "float"
                                 else struct.pack(e + "B", int(x))
                                 for x, (_, t) in zip(r, props))
                        for r in rows)
        body += b"".join(struct.pack(e + "B" + "i" * len(f), len(f), *f)
                         for f in _F)
        data = text.encode() + body
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
@pytest.mark.parametrize("normals,uvs", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_ply_matches_jax(tmp_path, fmt, normals, uvs):
    p = _write_ply(tmp_path / "m.ply", fmt, normals, uvs,
                   ("s", "t") if fmt == "binary_big_endian" else ("u", "v"))
    a, b = tply.load_ply(p), jply.load_ply(p)
    assert len(a) == len(b) == 4
    assert a[1].shape == (6, 3)
    assert (a[2] is None) == (not normals) and (a[3] is None) == (not uvs)
    for x, y in zip(a, b):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


_OBJ = {
    "positions": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nf 1 2 3 4\nf 1 3 4\n",
    "uvs": ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nvt 0 0\nvt 1 0\nvt 1 1\n"
            "vt 0 1\nf 1/1 2/2 3/3 4/4\n"),
    "full_negative": ("# quad and tri with negative indices\n"
                      "v 0 0 0\nv 2 0 0\nv 2 1 0\nv 0 1 0\nv 1 0.5 1\n"
                      "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                      "vn 0 0 1\nvn 0 0.6 0.8\n"
                      "f 1/1/1 2/2/1 3/3/1 4/4/1\nf -5/-4/-1 -4/-3/-1 -1/-2/-2\n"),
    "normals_only": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 -1\nf 1//1 2//1 3//1\n",
}


@pytest.mark.parametrize("kind", list(_OBJ))
def test_obj_matches_jax(tmp_path, kind):
    p = tmp_path / "m.obj"
    p.write_text(_OBJ[kind])
    a, b = tobj.load_obj(str(p)), jobj.load_obj(str(p))
    for x, y in zip(a, b):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, y)
    sa = tmesh.build_soup_from_corners(*a, to_world=ttf.Transform.scale(2))
    sb = jmesh.build_soup_from_corners(*b, to_world=jtf.Transform.scale(2))
    for f in dataclasses.fields(sb):
        np.testing.assert_array_equal(getattr(sa, f.name),
                                      getattr(sb, f.name))


# ---------------------------------------------------------------------------
# procedural shapes
# ---------------------------------------------------------------------------

def _shapes(m, tf):
    T = tf.Transform
    tw = T.translate([0.1, 0.2, -0.3]) @ T.rotate([0, 1, 1], 0.4)
    return {
        "icosahedron": m.icosahedron([0.1, 0.2, 0.3], 0.7, tw),
        "sphere": m.sphere([0, 1, 0], 0.5, tw, tessellation=24),
        "cube": m.cube(0.3, T.scale([2, 1, 1])),
        "rectangle_tess": m.rectangle(2.0, tw, tessellation=3),
        "cylinder": m.cylinder([0, 0, 0], [0.2, 1, -0.1], 0.3, tw,
                               phi_tessellation=12),
        "prism": m.prism(0.3, 0.2, math.radians(50), tw),
        "lens_biconvex": m.lens([0, 0, 0], 0.1, 0.5, 0.4, 0.02, tw,
                                tessellation=8),
        "lens_meniscus": m.lens([0, 1, 0], 0.1, 0.5, -0.3, 0.0, None,
                                tessellation=7),
        "lens_flat": m.lens([0, 0, 0], 0.2, 0.0, 0.0, 0.0, tw,
                            tessellation=6),
        "lens_planoconcave": m.lens([0, 0, 0], 0.2, 0.0, -0.5, 0.05, None),
    }


@pytest.mark.parametrize("name", list(_shapes(tmesh, ttf)))
def test_mesh_shapes_bit_equal(name):
    a, b = _shapes(tmesh, ttf)[name], _shapes(jmesh, jtf)[name]
    assert a.num_tris == b.num_tris > 0
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f.name


# ---------------------------------------------------------------------------
# colourimetry, responses, data files
# ---------------------------------------------------------------------------

def test_cie_and_develop_matrix_match_jax():
    for cs in tcie.PRIMARIES:
        for wp in tcie.WHITEPOINTS:
            np.testing.assert_array_equal(tcie.xyz_to_rgb_matrix(cs, wp),
                                          jcie.xyz_to_rgb_matrix(cs, wp))
            np.testing.assert_array_equal(tcie.rgb_to_xyz_matrix(cs, wp),
                                          jcie.rgb_to_xyz_matrix(cs, wp))
    for T in (2700.0, 5000.0, 6500.0):
        np.testing.assert_array_equal(tcie.planckian_locus_xyz(T),
                                      jcie.planckian_locus_xyz(T))
    for typ in ("RGB", "XYZ", "monochromatic"):
        a = tresp.Response(type=typ, colourspace="AdobeRGB",
                           white_point="D50").develop_matrix()
        b = jresp.Response(type=typ, colourspace="AdobeRGB",
                           white_point="D50").develop_matrix()
        assert (a is None) == (b is None) == (typ != "RGB")
        if a is not None:
            np.testing.assert_array_equal(a, b)


_RII = """\
REFERENCES: "test data"
DATA:
  - type: formula 2
    wavelength_range: 0.3 0.9
    coefficients: 0 1.03961212 0.00600069867 0.231792344 0.0200179144 1.01046945 103.560653
  - type: tabulated k
    data: |
        0.30 1.0e-6
        0.60 2.0e-7
        0.90 5.0e-8
"""
_EMISSION = """\
DATA:
  - type: tabulated intensity
    data: |
        400 0.1
        500 1.0
        600 0.6
        700 0.2
"""


def test_data_file_loaders_match_jax(tmp_path, monkeypatch):
    pytest.importorskip("yaml")
    for mod in (tior, jior):
        monkeypatch.setattr(mod, "DATA_SEARCH_PATHS",
                            [str(tmp_path / "stub"), str(tmp_path / "data")])
        with pytest.raises(FileNotFoundError):
            mod.load_material_ior("glass")
        with pytest.raises(FileNotFoundError):
            mod.load_emission_spectrum("lamp")
    for sub, name, text in (("ior", "glass", _RII),
                            ("emission", "lamp", _EMISSION)):
        for root, body in (("stub", "version https://git-lfs.github.com/"
                                    "spec/v1\noid sha256:0\n"),
                           ("data", text)):
            d = tmp_path / root / sub
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{name}.yml").write_text(body)
    # the git-lfs pointer of the first root is passed over
    assert tior.resolve_data("ior/glass.yml") == \
        jior.resolve_data("ior/glass.yml") == \
        str(tmp_path / "data" / "ior" / "glass.yml")
    a, b = tior.load_material_ior("glass"), jior.load_material_ior("glass")
    for f in ("k_nodes", "n", "kappa"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    a = tior.load_emission_spectrum("lamp")
    b = jior.load_emission_spectrum("lamp")
    np.testing.assert_array_equal(a.k_nodes, b.k_nodes)
    np.testing.assert_array_equal(a.values, b.values)


# ---------------------------------------------------------------------------
# the XML loader on a scene with every element
# ---------------------------------------------------------------------------

SCENE = """<?xml version="1.0"?>
<scene version="0.1">
  <default name="res" value="16"/>
  <default name="spp" value="2"/>
  <default name="with_cube" value="true"/>
  <default name="R" value="0.25"/>
  <integrator type="plt_path">
    <integer name="max_depth" value="$spp + 2"/>
    <boolean name="russian_roulette" value="false"/>
    <boolean name="MIS" value="true"/>
    <boolean name="FSD" value="($res &gt; 8 && $spp &lt; 16)"/>
  </integrator>
  <sensor type="perspective" id="cam">
    <quantity name="fov" value="(2*25)°"/>
    <integer name="samples" value="$spp"/>
    <transform name="to_world"><lookat origin="0, 1m, 320cm" target="0,1,0"
      up="0,1,0"/></transform>
    <film>
      <integer name="width" value="$res"/>
      <integer name="height" value="$res/2"/>
      <float name="rfilter_scale" value="1.5"/>
      <response type="RGB"><string name="colourspace" value="AdobeRGB"/>
        <string name="white_point" value="D50"/>
        <tonemap type="gamma"><float name="gamma" value="2.4"/>
          <float name="scale" value="3"/></tonemap></response>
    </film>
  </sensor>
  <sensor type="virtual_plane" id="plane" polarimetric="false">
    <quantity name="extent" value="2m, 1.5m"/>
    <quantity name="alpha" value="0.5°"/>
    <integer name="samples" value="4"/>
    <transform name="to_world"><rotate x="1" angle="-90°"/>
      <translate value="0, 0.5m, 0"/></transform>
    <film><integer name="width" value="8"/>
      <response type="multichannel">
        <spectrum type="gaussian" wavelength="550nm" stddev="20nm"/>
        <spectrum type="piecewise_linear"><bin wavelength="450nm" value="0.2"/>
          <bin wavelength="650nm" value="1"/></spectrum>
        <tonemap type="dB"><range value="-60 .. -10"/>
          <string name="colourmap" value="Viridis"/></tonemap>
      </response></film>
  </sensor>
  <sensor type="perspective" id="off">
    <boolean name="enabled" value="false"/></sensor>
  <spectrum id="warm" blackbody="3200K"><float name="scale" value="1e-13"/>
  </spectrum>
  <spectrum id="glassior" constant="(1.5, 0.01i)"/>
  <texture type="checkerboard" id="checks">
    <spectrum name="colour1" value="0.8"/>
    <spectrum name="color2" constant="0.1"/>
  </texture>
  <texture type="transform" id="checks_tiled">
    <ref id="checks"/><matrix value="4, 0, 0, 3"/>
    <translate value="0.25, 0.5"/>
  </texture>
  <texture type="bitmap" id="img"><path value="tex.png"/></texture>
  <texture id="func" function="a*u + b*(1-v)">
    <texture name="a" type="constant"><spectrum value="0.6"/></texture>
    <spectrum name="b" rgb="0.1, 0.4, 0.2"/>
  </texture>
  <bsdf type="diffuse" id="white">
    <spectrum name="reflectance" value="0.7"/></bsdf>
  <bsdf type="diffuse" id="rgbwall">
    <spectrum name="reflectance" rgb="0.8, 0.1, 0.1"/></bsdf>
  <bsdf type="diffuse" id="checkfloor">
    <ref name="reflectance" id="checks_tiled"/></bsdf>
  <bsdf type="twosided" id="bitmapwall"><bsdf type="diffuse">
    <texture name="reflectance" bitmap="tex.png"/></bsdf></bsdf>
  <bsdf type="diffuse" id="imgwall"><ref name="reflectance" id="img"/></bsdf>
  <bsdf type="diffuse" id="funcwall"><ref name="reflectance" id="func"/></bsdf>
  <bsdf type="dielectric" id="glass">
    <spectrum name="IOR" constant="(1.5, 0.01i)"/>
    <spectrum name="extIOR" value="1.0"/>
    <spectrum name="reflection_scale" value="0.9"/>
    <spectrum name="transmission_scale" type="binned">
      <bin wavelength_range="380nm .. 500nm" value="0.5"/>
      <bin wavelength_range="500nm .. 780nm" value="1"/></spectrum>
  </bsdf>
  <bsdf type="surface_spm" id="rough">
    <spectrum name="IOR" constant="(0.27, 2.9i)"/>
    <surface_profile type="gaussian"><texture name="roughness" type="scale">
      <texture type="constant"><spectrum value="0.5"/></texture>
      <float name="scale" value="0.6"/></texture></surface_profile>
  </bsdf>
  <bsdf type="surface_spm" id="concrete">
    <spectrum name="IOR" ITU="concrete"/>
    <surface_profile type="fractal"><float name="gamma" value="3"/>
      <float name="T" value="400"/><float name="sigma" value="0.02"/>
    </surface_profile>
  </bsdf>
  <bsdf type="composite" id="comp">
    <bin wavelength_range="380nm .. 550nm"><ref id="rough"/></bin>
    <bin wavelength_range="550nm .. 830nm"><bsdf type="normalmap">
      <bsdf type="diffuse"><spectrum name="reflectance" value="0.5"/></bsdf>
      <texture type="bitmap"><path value="tex.png"/></texture></bsdf></bin>
  </bsdf>
  <bsdf type="mask" id="masked">
    <bsdf type="diffuse"><spectrum name="reflectance" rgb="0.6, 0.5, 0.3"/>
    </bsdf>
    <texture name="opacity" type="checkerboard">
      <spectrum name="colour1" value="1"/><spectrum name="colour2" value="0"/>
    </texture>
  </bsdf>
  <bsdf scale=".5" id="half"><ref id="white"/></bsdf>
  <bsdf type="scale" id="scaled">
    <bsdf type="diffuse"><spectrum name="reflectance" value="0.9"/></bsdf>
    <float name="scale" value="0.8"/>
    <spectrum name="scale" value="0.5"/>
  </bsdf>
  <shape type="rectangle"><float name="length" value="2"/>
    <transform name="to_world"><rotate x="1" angle="-90°"/></transform>
    <ref id="checkfloor"/></shape>
  <shape type="rectangle"><point name="p" value="-1, 0, -1"/>
    <point name="x" value="2, 0, 0"/><point name="y" value="0, 2, 0"/>
    <ref id="bitmapwall"/></shape>
  <shape type="rectangle"><float name="length" value="2"/>
    <transform name="to_world"><rotate y="1" angle="90°"/>
      <translate x="-1" y="1m"/></transform><ref id="rgbwall"/></shape>
  <shape type="rectangle"><float name="length" value="2"/>
    <transform name="to_world"><rotate y="1" angle="-90°"/>
      <translate x="1" y="1"/></transform><ref id="comp"/></shape>
  <shape type="rectangle"><float name="length" value="2"/>
    <transform name="to_world"><rotate x="1" angle="90°"/>
      <translate y="2"/></transform><ref id="funcwall"/></shape>
  <shape type="rectangle"><float name="length" value="0.3"/>
    <transform name="to_world"><translate value="-0.6, 1.2, -0.9"/>
    </transform><ref id="imgwall"/></shape>
  <shape type="cube"><boolean name="enabled" value="$with_cube"/>
    <float name="length" value="0.3"/>
    <transform name="to_world"><scale value="1"/><scale x="2" y="1" z="1"/>
      <translate value="0.5, 0.15, 0.3"/></transform><ref id="half"/></shape>
  <shape type="sphere"><point name="center" x="-0.4" y="0.4" z="0"/>
    <float name="radius" value="$R"/>
    <integer name="tessellation" value="12"/><ref id="glass"/></shape>
  <shape type="cylinder"><point name="p0" value="0.5, 0, -0.5"/>
    <point name="p1" value="0.5, 0.8, -0.5"/><float name="radius" value="0.1"/>
    <integer name="tessellation" value="10"/><ref id="rough"/></shape>
  <shape type="prism"><float name="length" value="0.3"/>
    <float name="height" value="0.2"/><quantity name="angle" value="50°"/>
    <transform name="to_world"><translate value="-0.3, 0, 0.5"/></transform>
    <ref id="scaled"/></shape>
  <shape type="lens"><point name="center" value="0, 1, 0.4"/>
    <float name="radius" value="0.1"/><float name="R1" value="0.5"/>
    <float name="R2" value="-0.3"/><float name="thickness" value="0.02"/>
    <integer name="tessellation" value="8"/><ref id="glass"/></shape>
  <shape type="ply"><path value="mesh.ply"/><float name="scale" value="0.5"/>
    <transform name="to_world"><translate value="0, 0.2, 0"/></transform>
    <ref id="concrete"/></shape>
  <shape type="ply"><path value="missing.ply"/><ref id="white"/></shape>
  <shape type="rectangle"><float name="length" value="0.4"/>
    <transform name="to_world"><translate value="0.2, 1, 0.6"/></transform>
    <ref id="masked"/></shape>
  <shape type="rectangle"><float name="length" value="0.5"/>
    <transform name="to_world"><rotate x="1" angle="90°"/>
      <translate value="0, 1.99, 0"/></transform>
    <bsdf type="diffuse"><spectrum name="reflectance" value="0.1"/></bsdf>
    <emitter type="area"><spectrum blackbody="5000K">
      <float name="scale" value="5e-13"/></spectrum></emitter></shape>
  <emitter type="point" id="pt"><point name="position" value="0.2, 1.7, 0.1"/>
    <spectrum type="analytic"
      expr="1e-14 * exp(-((lambda - 600e-9)/50e-9)^2)"/></emitter>
  <emitter type="spot" id="spot"><transform name="to_world">
      <lookat origin="-0.6, 1.75, 0.7" target="0.35, 0.45, 0.1"/></transform>
    <quantity name="beam_width" value="12°"/>
    <quantity name="cutoff_angle" value="20°"/>
    <spectrum type="piecewise_linear"><bin wavelength="700nm" value="1e-13"/>
      <bin wavelength="500nm" value="3e-13"/></spectrum></emitter>
  <emitter type="directional" id="sun"><transform name="to_world">
      <lookat origin="0,0,0" target="0.3,-1,0.2"/></transform>
    <spectrum type="composite">
      <bin wavelength_range="380nm .. 550nm"><spectrum value="2e-15"/></bin>
      <bin wavelength_range="550nm .. 780nm">
        <spectrum rgb="1e-15, 2e-15, 1e-15"/></bin>
      <float name="scale" value="0.5"/></spectrum></emitter>
  <emitter type="point" id="warmpt"><point name="position" value="0, 1, 0"/>
    <ref id="warm"/><spectrum type="uniform" value="$R * 1e-15"/></emitter>
  <include path="more.xml"/>
</scene>
"""
# an include file of several top-level elements (wrapped on parse)
MORE = """<shape type="rectangle"><float name="length" value="0.2"/>
  <transform name="to_world"><matrix value="1,0,0,0.7, 0,1,0,0.5, 0,0,1,-0.9,
    0,0,0,1"/></transform><ref id="white"/></shape>
<emitter type="point"><point name="position" value="-0.5, 1.5, 0.2"/>
  <spectrum type="discrete" wavelength="532nm" value="1e-14"/></emitter>
"""


def write_scene(d, text=SCENE):
    """The scene file, its include, an 8×8 RGB PNG and a PLY mesh in d."""
    rng = np.random.default_rng(3)
    (d / "tex.png").write_bytes(encode_png(rng.uniform(0, 1, (8, 8, 3))))
    _write_ply(d / "mesh.ply", "binary_little_endian", True, True)
    (d / "more.xml").write_text(MORE)
    p = d / "scene.xml"
    p.write_text(text)
    return str(p)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    pytest.importorskip("PIL")              # the JAX loader's bitmaps
    p = write_scene(tmp_path_factory.mktemp("scene"))
    defines = {"spp": "3"}
    return (txml.load_scene_xml(p, defines), jxml.load_scene_xml(p, defines),
            p)


def test_scene_loads_like_jax(scenes):
    ts, js, _ = scenes
    assert len(ts.shapes) == len(js.shapes) == 15   # missing.ply skipped
    assert len(ts.emitters) == len(js.emitters) == 6
    assert [s.id for s in ts.sensors] == [s.id for s in js.sensors] \
        == ["cam", "plane"]
    assert dataclasses.asdict(ts.integrator) == \
        dataclasses.asdict(js.integrator)
    assert ts.integrator.max_depth == 5 and not ts.integrator.russian_roulette
    cam, jcam = ts.sensors[0], js.sensors[0]
    for f in ("width", "height", "fov", "samples", "rfilter_scale",
              "polarimetric", "ray_trace_only"):
        assert getattr(cam, f) == getattr(jcam, f), f
    assert (cam.width, cam.height, cam.samples) == (16, 8, 3)
    np.testing.assert_array_equal(cam.to_world, jcam.to_world)
    assert cam.response.develop_matrix().tobytes() == \
        jcam.response.develop_matrix().tobytes()
    assert dataclasses.asdict(cam.response.tonemap) == \
        dataclasses.asdict(jcam.response.tonemap)
    plane, jplane = ts.sensors[1], js.sensors[1]
    assert (plane.extent, plane.alpha) == (jplane.extent, jplane.alpha)
    np.testing.assert_array_equal(plane.to_world, jplane.to_world)
    k = np.geomspace(8e6, 1.7e7, 64)
    for em, jem in zip(ts.emitters, js.emitters):
        assert type(em).__name__ == type(jem).__name__
        np.testing.assert_array_equal(em.spectrum.eval(k),
                                      jem.spectrum.eval(k))
        for f in ("position", "direction", "beam_width", "cutoff"):
            if hasattr(jem, f):
                np.testing.assert_array_equal(getattr(em, f),
                                              getattr(jem, f))
    assert len(ts.shapes[-1].soup.positions) == 2


def test_missing_assets_warn_like_jax(scenes):
    _, _, p = scenes
    out = {}
    for name, mod in (("port", txml), ("jax", jxml)):
        loader = mod.Loader(os.path.dirname(p), {})
        root = mod._parse_xml_file(p)
        for c in root:
            if c.tag == "default" and c.get("name") not in loader.defines:
                loader.defines[c.get("name")] = c.get("value")
        mod._load_elements(loader, root, mod.Scene())
        out[name] = loader.warnings
    assert out["port"] == out["jax"]
    assert len(out["port"]) == 1 and "missing.ply" in out["port"][0]


def test_scene_bake_equals_jax(scenes):
    """Every table of the port's bake equals the JAX bake's (the JAX
    bake's triangles in BVH order, its edges canonicalized), and so do the
    per-sensor spectral samplers."""
    ts, js, _ = scenes
    jb = jbuild(js)
    ja, perm = _flatten(jb.data), np.asarray(jb.bvh.tri_order)
    ta, per_sensor = bake_scene_arrays(ts)
    assert ta["geo.p0"].shape[0] > 300
    for key in bridge.KEYS:
        a, b = ja[key], np.asarray(ta[key])
        if key in TRI_KEYS:
            np.testing.assert_array_equal(b[perm], a, err_msg=key)
        elif key == "geo.mxu_center":      # a mean: summation order differs
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        elif key in ("emitters.etri_idx", "emitters.etri_cdf") \
                or key.startswith("edges."):
            continue
        else:
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(b, a, err_msg=key)
    ej, et = _emitter_tris(ja, idx_map=perm), _emitter_tris(ta)
    assert ej.keys() == et.keys()
    for e in ej:
        assert ej[e].keys() == et[e].keys()
        for tri, p in ej[e].items():
            assert abs(et[e][tri] - p) < 1e-6
    ecj, ect = _canonical_edges(ja, tri_map=perm), _canonical_edges(ta)
    assert len(ect["p0"]) == len(ecj["p0"]) > 0
    for k in bridge.EDGE_KEYS:
        np.testing.assert_array_equal(ect[k], ecj[k], err_msg=k)
    assert len(per_sensor) == len(jb.spectral_per_sensor) == 2
    for sp, jsp in zip(per_sensor, jb.spectral_per_sensor):
        jf = _flatten(jsp)
        for k in bridge.SPECTRAL_KEYS:
            np.testing.assert_array_equal(np.asarray(sp[k]), jf[k],
                                          err_msg=k)


def test_obj_shape_and_disabled_elements(tmp_path):
    (tmp_path / "m.obj").write_text(_OBJ["full_negative"])
    text = SCENE.replace(
        '<include path="more.xml"/>',
        '<shape type="obj" id="o"><path value="m.obj"/>'
        '<float name="scale" value="2"/><boolean name="face_normals" '
        'value="false"/><ref id="white"/></shape>')
    p = write_scene(tmp_path, text)
    ts = txml.load_scene_xml(p, {"with_cube": "false"})
    assert len(ts.shapes) == 14                  # the cube is off
    soup = ts.shapes[-1].soup
    ref = jmesh.build_soup_from_corners(
        *jobj.load_obj(str(tmp_path / "m.obj")),
        to_world=jtf.Transform.scale([2.0] * 3))
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(soup, f.name),
                                      getattr(ref, f.name))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_bitmaps_load_like_jax(tmp_path, mode):
    """Every PNG colour type the port decodes gives the JAX loader's
    (PIL's) linear RGB texture bit for bit."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    img = Image.fromarray(rng.integers(0, 256, (9, 7, 4), np.uint8), "RGBA")
    img = img.convert(mode) if mode != "P" else img.convert("RGB").convert(
        "P", palette=Image.ADAPTIVE, colors=200)
    img.save(tmp_path / "b.png")
    a = txml._load_bitmap(txml.Loader(str(tmp_path)), "b.png")
    b = jxml._load_bitmap(jxml.Loader(str(tmp_path)), "b.png")
    assert a.data.dtype == b.data.dtype and a.data.shape == (9, 7, 3)
    assert a.data.tobytes() == b.data.tobytes()


def test_bitmap_faults(tmp_path):
    """A missing bitmap becomes mid-grey with a warning, as in the JAX
    loader; a file the port cannot decode raises SceneLoadError naming it."""
    loader = txml.Loader(str(tmp_path))
    tex = txml._load_bitmap(loader, "nothere.png")
    assert tex.rgb == (0.5, 0.5, 0.5) and "nothere.png" in loader.warnings[0]
    head = b"\x89PNG\r\n\x1a\n"
    ihdr = struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)
    (tmp_path / "deep.png").write_bytes(
        head + struct.pack(">I", len(ihdr)) + b"IHDR" + ihdr + b"\0" * 4)
    (tmp_path / "photo.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 32)
    Image = pytest.importorskip("PIL.Image")
    Image.fromarray(np.arange(12, dtype=np.uint8).reshape(3, 4)).convert(
        "RGB").convert("P", palette=Image.ADAPTIVE, colors=12).save(
            tmp_path / "four_bit.png")
    data = encode_png(np.random.default_rng(0).uniform(0, 1, (16, 16, 3)))
    (tmp_path / "cut.png").write_bytes(data[:len(data) // 2])
    for name in ("deep.png", "photo.jpg", "four_bit.png", "cut.png"):
        with pytest.raises(txml.SceneLoadError, match=name):
            txml._load_bitmap(loader, name)


def test_loader_errors():
    with pytest.raises(txml.SceneLoadError, match="undefined"):
        txml.Loader("", {}).subst("$nope")
    loader = txml.Loader("", {})
    with pytest.raises(txml.SceneLoadError, match="unresolved"):
        txml._deref(loader, txml.ET.fromstring('<ref id="x"/>'))


# ---------------------------------------------------------------------------
# the benchmark box as XML
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emitter", ["area", "point"])
def test_box_xml_bakes_like_make_box_scene(tmp_path, emitter):
    p = tmp_path / "box.xml"
    p.write_text(box_scene_xml(16, 2, 8, True, emitter))
    scene = txml.load_scene_xml(str(p))
    ref = make_box_scene(16, 2, emitter)
    a, sa = bake_scene_arrays(scene)
    b, sb = bake_scene_arrays(ref)
    ranges = ("tables.spectra.log_kmin", "tables.spectra.log_kmax")
    for key in b:
        if key not in ranges:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for k in sb[0]:
        np.testing.assert_array_equal(sa[0][k], sb[0][k], err_msg=k)
    # the uniform rows: other grid ranges, the same values
    np.testing.assert_array_equal(a["tables.spectra.vals"],
                                  b["tables.spectra.vals"])
    (sensor,), (rsensor,) = scene.sensors, ref.sensors
    np.testing.assert_array_equal(sensor.to_world, rsensor.to_world)
    assert (sensor.fov, sensor.width, sensor.samples, sensor.id) == \
        (rsensor.fov, 16, 2, "camera")
    assert scene.integrator.max_depth == 8 and scene.integrator.fsd


def _classical_bars(img, ref):
    mean, mref = img.mean((0, 1)), ref.mean((0, 1))
    assert (np.abs(mean - mref) <= 0.01 * np.abs(mref)).all()
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    assert (np.abs(img - ref) <= 1e-3 * scale).all(-1).mean() >= 0.98


def _wave_bars(img, ref):
    mean, mref = img.mean((0, 1)), ref.mean((0, 1))
    assert (np.abs(mean - mref) <= 0.02 * np.abs(mref)).all()
    assert np.corrcoef(img.ravel(), ref.ravel())[0, 1] >= 0.999
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    assert (np.abs(img - ref) <= 1e-2 * scale).all(-1).mean() >= 0.90


@pytest.mark.parametrize("fsd", [False, True])
def test_box_xml_renders_like_jax(tmp_path, fsd):
    """The box file rendered at 16×16 × 4 spp, depth 3, by the JAX package
    (its loader, bake and render_scene) and by the port (its loader's
    scene over the JAX bake, on the CPU) with one seed and 1024 lanes."""
    p = tmp_path / "box.xml"
    p.write_text(box_scene_xml(16, 4, 3, fsd))
    jb = jbuild(jxml.load_scene_xml(str(p)))
    jimg, jst = jrender(jb, spp=4, batch_lanes=1024, seed=2)
    arrays = _flatten(jb.data)
    spectral = {k: arrays[f"spectral.{k}"] for k in bridge.SPECTRAL_KEYS}
    built = BuiltScene.upload(txml.load_scene_xml(str(p)), arrays,
                              [spectral], "cpu")
    img, st = render_scene(built, seed=2, device="cpu", pool_lanes=1024)
    assert st["mode"] == jst["mode"] == ("wave-compact" if fsd
                                         else "ray-compact")
    assert img.shape == jimg.shape == (16, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    (_wave_bars if fsd else _classical_bars)(img, np.asarray(jimg))
