"""Scene XML loader: the scene files' mitsuba-style dialect.

Port of wave_tracer_tpu/scene/xml.py onto the port's host model classes:
`<default>` and `-D` defines with `$name` substitution and expression
evaluation, unit-bearing quantity attributes ("19.75°", "10GHz",
".05mm"), `<ref id>` cross-references through the loader's registry,
`<include path>`, per-element `enabled` toggles, transform sequences
(later elements apply after earlier ones; lookat is exclusive), and the
element vocabulary: integrator, sensor (perspective / virtual_plane),
film + response + tonemap, bsdf trees (diffuse, dielectric, surface_spm
with its surface profile, twosided, mask, normalmap, the scale wrapper,
composite), textures (constant, bitmap, checkerboard, scale, transform,
function), spectra (constant / rgb / blackbody / gaussian / discrete /
piecewise_linear / binned / composite / analytic / data-file / ITU),
shapes (rectangle, cube, sphere, cylinder, prism, lens, obj, ply) and
emitters (area, point, spot, directional). A shape whose asset is
missing (or a git-lfs pointer) is skipped with a warning.

Bitmaps are PNG files, decoded by render/output.py (non-interlaced 8-bit
grey, grey+alpha, RGB, RGBA and palette images), converted to RGB and
linearized by ^2.2; a bitmap file that is missing is replaced by mid-grey
with a warning, one that cannot be decoded raises SceneLoadError. OBJ
shapes go through `mesh.build_soup_from_corners`.
"""

from __future__ import annotations

import copy
import math
import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from wave_tracer_tpu_torch.bsdf.model import (CompositeBSDF, DielectricBSDF,
                                              DiffuseBSDF, Material, SpmBSDF,
                                              SurfaceProfile)
from wave_tracer_tpu_torch.core.expr import evaluate
from wave_tracer_tpu_torch.core.quantity import (
    parse_complex, parse_quantity, parse_quantity_vector, parse_range,
    wavelength_m, wavenumber_from_wavelength_m)
from wave_tracer_tpu_torch.core.transform import Transform
from wave_tracer_tpu_torch.emitter.model import (AreaEmitter,
                                                 DirectionalEmitter,
                                                 PointEmitter, SpotEmitter)
from wave_tracer_tpu_torch.geometry import mesh as mesh_mod
from wave_tracer_tpu_torch.geometry import obj as obj_mod
from wave_tracer_tpu_torch.geometry import ply as ply_mod
from wave_tracer_tpu_torch.render.output import read_png
from wave_tracer_tpu_torch.scene.model import IntegratorConfig, Scene, Shape
from wave_tracer_tpu_torch.sensor.perspective import PerspectiveSensor
from wave_tracer_tpu_torch.sensor.response import Response
from wave_tracer_tpu_torch.sensor.tonemap import Tonemap
from wave_tracer_tpu_torch.sensor.virtual_plane import VirtualPlaneSensor
from wave_tracer_tpu_torch.spectrum import ior as ior_mod
from wave_tracer_tpu_torch.spectrum.spectra import (
    AnalyticSpectrum, BinnedSpectrum, BlackbodySpectrum, ComplexSpectrum,
    ComplexUniformSpectrum, CompositeSpectrum, DiscreteSpectrum,
    GaussianSpectrum, K_VISIBLE_MAX, K_VISIBLE_MIN, PiecewiseLinearSpectrum,
    RGBSpectrum, UniformSpectrum)
from wave_tracer_tpu_torch.texture.texture import (BitmapTexture,
                                                   CheckerboardTexture,
                                                   ConstantRGBTexture,
                                                   ConstantSpectrumTexture)

TWO_PI = 2.0 * math.pi


class SceneLoadError(RuntimeError):
    pass


_RAW_AMP_RE = re.compile(rb"&(?!(amp|lt|gt|quot|apos|#)[a-zA-Z0-9]*;)")


def _parse_xml_file(path: str) -> ET.Element:
    """Parse leniently: scene files may hold raw '&&' inside attribute
    values; stray ampersands are escaped before ElementTree sees them."""
    with open(path, "rb") as f:
        data = f.read()
    data = _RAW_AMP_RE.sub(b"&amp;", data)
    try:
        return ET.fromstring(data)
    except ET.ParseError:
        # include files may hold several top-level elements: wrap them
        data = re.sub(rb"<\?xml[^>]*\?>", b"", data)
        return ET.fromstring(b"<scene>" + data + b"</scene>")


_DOLLAR_RE = re.compile(r"\$([A-Za-z_][A-Za-z0-9_]*)")


class Loader:
    def __init__(self, scene_dir: str, defines: dict | None = None,
                 mesh_scale: float = 1.0):
        self.scene_dir = scene_dir
        self.defines: dict[str, str] = dict(defines or {})
        self.mesh_scale = mesh_scale
        self.registry: dict[str, object] = {}   # id → loaded element
        self.warnings: list[str] = []

    # -- attribute plumbing ----------------------------------------------
    def subst(self, s: str) -> str:
        """$define substitution."""
        if "$" not in s:
            return s

        def repl(m):
            name = m.group(1)
            if name not in self.defines:
                raise SceneLoadError(f"undefined $${name}")
            return str(self.defines[name])
        return _DOLLAR_RE.sub(repl, s)

    def attr(self, node, name, default=None):
        v = node.get(name)
        if v is None:
            return default
        return self.subst(v)

    def number(self, s: str) -> float:
        return float(evaluate(self.subst(s)))

    def quantity(self, s: str) -> float:
        """SI value of a quantity attribute (expression-aware)."""
        return parse_quantity(self.subst(s)).value

    def named_children(self, node):
        """{name-attr: child} for property children."""
        out = {}
        for c in node:
            n = c.get("name")
            if n:
                out[n] = c
        return out

    def resolve_path(self, rel: str) -> str:
        p = os.path.join(self.scene_dir, rel)
        if not os.path.isfile(p):
            raise SceneLoadError(f"file not found: {rel}")
        with open(p, "rb") as fh:
            if fh.read(30).startswith(b"version https://git-lfs"):
                raise SceneLoadError(f"asset is a git-lfs stub: {rel}")
        return p

    def warn(self, msg):
        self.warnings.append(msg)


def _get_props(loader: Loader, node):
    """Parse typed property children: integer/float/boolean/string/quantity/
    point — returns dict name → python value."""
    props = {}
    for c in node:
        tag = c.tag
        name = c.get("name")
        if tag == "integer":
            props[name] = int(loader.number(c.get("value")))
        elif tag == "float":
            props[name] = loader.number(c.get("value"))
        elif tag == "boolean":
            v = loader.subst(c.get("value")).strip()
            props[name] = bool(evaluate(v)) if any(
                ch in v for ch in "()&|=<>!") else v.lower() == "true"
        elif tag == "string":
            props[name] = loader.subst(c.get("value"))
        elif tag == "quantity":
            val = loader.subst(c.get("value"))
            if "," in val:
                props[name] = [q.value for q in parse_quantity_vector(val)]
            else:
                props[name] = parse_quantity(val).value
        elif tag == "point":
            if c.get("value"):
                props[name] = [q.value for q in parse_quantity_vector(
                    loader.subst(c.get("value")))]
            else:
                props[name] = [parse_quantity(loader.subst(
                    c.get(a, "0"))).value for a in "xyz"]
        elif tag == "path":
            props["path"] = loader.subst(c.get("value"))
    return props


def _enabled(loader: Loader, node) -> bool:
    for c in node:
        if c.tag == "boolean" and c.get("name") == "enabled":
            v = loader.subst(c.get("value")).strip()
            if any(ch in v for ch in "()&|=<>!"):
                return bool(evaluate(v))
            return v.lower() == "true"
    return True


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------

def load_transform(loader: Loader, node) -> Transform:
    """Sequence semantics: each element left-multiplies; lookat is
    exclusive."""
    lookat = [c for c in node if c.tag == "lookat"]
    if lookat:
        la = lookat[0]
        origin = [q.value for q in parse_quantity_vector(
            loader.subst(la.get("origin", "0,0,0")))]
        target = [q.value for q in parse_quantity_vector(
            loader.subst(la.get("target", "0,0,1")))]
        up = None
        if la.get("up"):
            up = [loader.number(x) for x in
                  loader.subst(la.get("up")).split(",")]
        return Transform.lookat(origin, target, up)

    t = Transform()
    for c in node:
        if c.tag == "matrix":
            vals = [parse_quantity(p.strip()).value
                    for p in loader.subst(c.get("value")).split(",")]
            t = Transform.from_rows(vals) @ t
        elif c.tag == "rotate":
            axis = np.array([loader.number(c.get(a, "0")) for a in "xyz"])
            ang = parse_quantity(loader.subst(c.get("angle", "0"))).value
            t = Transform.rotate(axis, ang) @ t
        elif c.tag == "translate":
            if c.get("value"):
                tr = [q.value for q in parse_quantity_vector(
                    loader.subst(c.get("value")))]
            else:
                tr = [parse_quantity(loader.subst(c.get(a, "0m"))).value
                      if c.get(a) else 0.0 for a in "xyz"]
            t = Transform.translate(tr) @ t
        elif c.tag == "scale":
            if c.get("value"):
                v = loader.number(c.get("value"))
                sc = [v, v, v]
            else:
                sc = [loader.number(c.get(a, "1")) for a in "xyz"]
            t = Transform.scale(sc) @ t
    return t


def _to_world(loader: Loader, node) -> Transform:
    for c in node:
        if c.tag == "transform" and c.get("name") in ("to_world", None):
            return load_transform(loader, c)
    return Transform()


# --------------------------------------------------------------------------
# spectra
# --------------------------------------------------------------------------

def _wavelength_attr_to_k(loader: Loader, s: str) -> float:
    """Wavelength attribute (length or frequency quantity) → k [rad/m]."""
    q = parse_quantity(loader.subst(s))
    lam = wavelength_m(q)
    return wavenumber_from_wavelength_m(lam)


def load_spectrum(loader: Loader, node, complex_ok=False):
    """Parse a <spectrum> node (every form of the dialect)."""
    scale = 1.0
    for c in node:
        if c.tag == "float" and c.get("name") == "scale":
            scale = loader.number(c.get("value"))

    # attribute shorthands
    if node.get("constant") is not None:
        raw = loader.subst(node.get("constant"))
        try:
            val = float(evaluate(raw))
            return UniformSpectrum(val * scale, K_VISIBLE_MIN / 1e4,
                                   K_VISIBLE_MAX * 10)
        except Exception:
            c = parse_complex(raw)
            return ComplexUniformSpectrum(c)
    if node.get("rgb") is not None:
        rgb = [loader.number(x)
               for x in loader.subst(node.get("rgb")).split(",")]
        return RGBSpectrum(tuple(rgb)).scaled(scale)
    if node.get("blackbody") is not None:
        T = parse_quantity(loader.subst(node.get("blackbody"))).value
        return BlackbodySpectrum(T=T, scale=scale)
    if node.get("emitter") is not None:
        s = ior_mod.load_emission_spectrum(loader.subst(node.get("emitter")))
        return s.scaled(scale)
    if node.get("material") is not None:
        return ior_mod.load_material_ior(loader.subst(node.get("material")))
    if node.get("ITU") is not None:
        return ior_mod.ITUComplexSpectrum(loader.subst(node.get("ITU")))

    typ = loader.attr(node, "type", "")
    if typ == "discrete":
        k0 = _wavelength_attr_to_k(loader, node.get("wavelength"))
        w = loader.number(node.get("value", "1")) * scale
        return DiscreteSpectrum(np.array([k0]), np.array([w]))
    if typ == "gaussian":
        k0 = _wavelength_attr_to_k(loader, node.get("wavelength"))
        lam0 = TWO_PI / k0
        lam_sd = parse_quantity(loader.subst(node.get("stddev"))).value
        if node.get("stddev") and "m" not in node.get("stddev"):
            # bare numbers are wavelengths in mm
            lam_sd = loader.number(node.get("stddev")) * 1e-3
        sigma_k = abs(k0 - TWO_PI / (lam0 + lam_sd))
        val = loader.number(node.get("value", "1")) * scale
        return GaussianSpectrum(k0=k0, sigma_k=max(sigma_k, 1e-3),
                                val0=val)
    if typ == "piecewise_linear":
        ks, vs = [], []
        for c in node:
            if c.tag == "bin":
                wl = c.get("wavelength")
                # bare numbers: wavelengths in mm
                q = parse_quantity(loader.subst(wl))
                lam = q.value if q.dim == "length" else q.value * 1e-3
                ks.append(TWO_PI / lam)
                vs.append(loader.number(c.get("value", "0")) * scale)
        if len(ks) == 1:
            ks.append(ks[0] * 1.0001)
            vs.append(vs[0])
        return PiecewiseLinearSpectrum(np.array(ks), np.array(vs))
    if typ == "binned":
        edges, vals = [], []
        for c in node:
            if c.tag == "bin":
                lo, hi = parse_range(loader.subst(c.get("wavelength_range")))
                edges.append((TWO_PI / hi.value, TWO_PI / lo.value))
                vals.append(loader.number(c.get("value", "0")) * scale)
        ks = sorted({e for pair in edges for e in pair})
        return BinnedSpectrum(np.array(ks), np.array(vals[:len(ks) - 1]))
    if typ == "composite":
        bins = []
        for c in node:
            if c.tag == "bin":
                lo, hi = parse_range(loader.subst(c.get("wavelength_range")))
                kmin = TWO_PI / hi.value
                kmax = TWO_PI / lo.value
                sub = [x for x in c if x.tag == "spectrum"]
                if sub:
                    bins.append((kmin, kmax,
                                 load_spectrum(loader, sub[0])))
        return CompositeSpectrum(bins=bins).scaled(scale)
    if typ == "analytic":
        return AnalyticSpectrum(loader.subst(node.get("expr", "1"))) \
            .scaled(scale)
    if typ == "uniform" or typ == "":
        if node.get("value") is not None:
            return UniformSpectrum(loader.number(node.get("value")) * scale,
                                   K_VISIBLE_MIN / 1e4, K_VISIBLE_MAX * 10)
    raise SceneLoadError(f"unsupported spectrum node: type={typ!r} "
                         f"attrs={dict(node.attrib)}")


# --------------------------------------------------------------------------
# textures
# --------------------------------------------------------------------------

def _load_bitmap(loader: Loader, path: str):
    """A PNG bitmap texture: RGB, linearized by ^2.2. A missing file is
    replaced by mid-grey (with a warning); one that cannot be decoded
    raises SceneLoadError."""
    try:
        fp = loader.resolve_path(path)
    except SceneLoadError as e:
        loader.warn(f"bitmap texture unavailable ({e}); "
                    "substituting mid-grey")
        return ConstantRGBTexture((0.5, 0.5, 0.5))
    try:
        arr = read_png(fp)
    except (ValueError, OSError) as e:
        raise SceneLoadError(f"cannot decode bitmap {path}: {e}") from e
    C = arr.shape[-1]
    rgb = np.repeat(arr[..., :1], 3, axis=-1) if C <= 2 else arr[..., :3]
    img = np.asarray(rgb, np.float32) / 255.0
    img = np.power(img, 2.2)   # sRGB-ish → linear
    return BitmapTexture(data=img)


def load_texture(loader: Loader, node):
    typ = loader.attr(node, "type", "")
    if node.tag == "spectrum":
        spec = load_spectrum(loader, node)
        return ConstantSpectrumTexture(spec)
    if node.tag == "ref":
        return _deref(loader, node)
    if node.get("bitmap") is not None:
        # <texture name=... bitmap="path"/> shorthand
        return _load_bitmap(loader, loader.subst(node.get("bitmap")))
    if typ == "transform":
        # UV-transform wrapper: the 2x2 matrix folds into the uv scale
        # (its diagonal)
        inner = None
        mat = np.eye(2)
        off = np.zeros(2)
        for c in node:
            if c.tag == "texture":
                inner = load_texture(loader, c)
            elif c.tag == "ref":
                inner = _deref(loader, c)
            elif c.tag == "matrix":
                vals = [loader.number(x) for x in
                        loader.subst(c.get("value")).split(",")]
                mat = np.asarray(vals, np.float64).reshape(2, 2)
            elif c.tag == "translate":
                off = np.asarray([loader.number(x) for x in
                                  loader.subst(c.get("value")).split(",")])
        if inner is None:
            raise SceneLoadError("transform texture without inner texture")
        if abs(mat[0, 1]) > 1e-9 or abs(mat[1, 0]) > 1e-9:
            loader.warn("non-diagonal texture transform approximated by "
                        "its diagonal")
        if isinstance(inner, (BitmapTexture, CheckerboardTexture)):
            inner.uv_scale = (inner.uv_scale[0] * mat[0, 0],
                              inner.uv_scale[1] * mat[1, 1])
            inner.uv_offset = (inner.uv_offset[0] + off[0],
                               inner.uv_offset[1] + (off[1] if len(off) > 1
                                                     else 0.0))
        return inner
    if typ == "function" or node.get("function") is not None:
        # expression over named child textures — rasterized at load time
        # into a bitmap
        expr = loader.subst(node.get("function", "0")) \
            if node.get("function") else "0"
        children = {}
        for c in node:
            if c.tag == "function":
                expr = loader.subst(c.get("value"))
            elif c.tag in ("texture", "spectrum"):
                children[c.get("name")] = load_texture(loader, c)
        R = 128
        uu, vv = np.meshgrid((np.arange(R) + 0.5) / R,
                             (np.arange(R) + 0.5) / R)
        out = np.zeros((R, R, 3), np.float32)
        fields = {}
        for name, tex in children.items():
            fields[name] = _rasterize_texture(tex, uu, vv)
        for ch in range(3):
            vals = np.zeros((R, R))
            it = np.nditer(vals, flags=["multi_index"])
            for _ in it:
                iy, ix = it.multi_index
                env = {n: float(f[iy, ix, ch]) for n, f in fields.items()}
                env.update(u=float(uu[iy, ix]), v=float(vv[iy, ix]))
                vals[iy, ix] = evaluate(expr, env)
            out[..., ch] = vals
        return BitmapTexture(data=np.flipud(out))
    if typ == "scale":
        inner = None
        scale_spec = None
        scale_val = 1.0
        for c in node:
            if c.tag == "texture":
                inner = load_texture(loader, c)
            elif c.tag == "spectrum" and c.get("name") == "scale":
                scale_spec = load_spectrum(loader, c)
            elif c.tag == "float" and c.get("name") == "scale":
                scale_val = loader.number(c.get("value"))
            elif c.tag == "ref":
                inner = _deref(loader, c)
        if inner is None:
            raise SceneLoadError("scale texture without inner texture")
        if isinstance(scale_spec, UniformSpectrum):
            inner.scale = inner.scale * scale_spec.value * scale_val
        elif scale_spec is not None:
            inner.scale_spectrum = scale_spec
            inner.scale = inner.scale * scale_val
        else:
            inner.scale = inner.scale * scale_val
        return inner
    if typ == "bitmap":
        path = None
        for c in node:
            if c.tag == "path":
                path = loader.subst(c.get("value"))
        props = _get_props(loader, node)
        path = props.get("path", path)
        return _load_bitmap(loader, path)
    if typ == "checkerboard":
        tex = CheckerboardTexture()
        for c in node:
            nm = c.get("name")
            if c.tag == "spectrum" and nm in ("colour1", "color1"):
                v = _const_val(loader, c)
                tex.rgb_a = (v, v, v)
            elif c.tag == "spectrum" and nm in ("colour2", "color2"):
                v = _const_val(loader, c)
                tex.rgb_b = (v, v, v)
        return tex
    if typ == "constant":
        for c in node:
            if c.tag == "spectrum":
                return ConstantSpectrumTexture(load_spectrum(loader, c))
        return ConstantRGBTexture((1.0, 1.0, 1.0))
    raise SceneLoadError(f"unsupported texture type {typ!r}")


def _rasterize_texture(tex, uu, vv):
    """Host-side RGB evaluation of a texture on a uv grid (function-texture
    rasterization)."""
    shape = uu.shape + (3,)
    if isinstance(tex, ConstantRGBTexture):
        return np.broadcast_to(np.asarray(tex.rgb, np.float32) * tex.scale,
                               shape)
    if isinstance(tex, ConstantSpectrumTexture):
        v = tex.spectrum.eval(np.array([1.2e7]))[0] * tex.scale
        return np.full(shape, v, np.float32)
    if isinstance(tex, BitmapTexture):
        h, w = tex.data.shape[:2]
        u = (uu * tex.uv_scale[0] + tex.uv_offset[0]) % 1.0
        v = (vv * tex.uv_scale[1] + tex.uv_offset[1]) % 1.0
        ix = np.clip((u * w).astype(int), 0, w - 1)
        iy = np.clip(((1.0 - v) * h).astype(int), 0, h - 1)
        return tex.data[iy, ix] * tex.scale
    if isinstance(tex, CheckerboardTexture):
        checker = ((np.floor(uu * tex.uv_scale[0])
                    + np.floor(vv * tex.uv_scale[1])) % 2.0) < 1.0
        return np.where(checker[..., None], np.asarray(tex.rgb_a),
                        np.asarray(tex.rgb_b)).astype(np.float32) * tex.scale
    return np.full(shape, 0.5, np.float32)


def _deref(loader: Loader, node):
    rid = node.get("id")
    if rid not in loader.registry:
        raise SceneLoadError(f"unresolved <ref id={rid!r}>")
    return loader.registry[rid]


# --------------------------------------------------------------------------
# bsdfs
# --------------------------------------------------------------------------

def load_profile(loader: Loader, node) -> SurfaceProfile:
    typ = loader.attr(node, "type", "dirac")
    prof = SurfaceProfile(type=typ)
    for c in node:
        nm = c.get("name")
        if c.tag == "float" and nm == "gamma":
            prof.gamma = loader.number(c.get("value"))
        elif c.tag in ("spectrum", "texture") and nm == "roughness":
            prof.roughness = load_texture(loader, c)
        elif nm == "sigma" or nm == "sigma_h":
            prof.sigma = loader.number(c.get("value", "0")) \
                if c.tag == "float" else _const_val(loader, c)
        elif nm == "T":
            prof.T = loader.number(c.get("value", "1")) \
                if c.tag == "float" else _const_val(loader, c)
    return prof


def _const_val(loader: Loader, node) -> float:
    if node.get("constant") is not None:
        return loader.number(node.get("constant"))
    if node.get("value") is not None:
        return loader.number(node.get("value"))
    return 0.0


def load_bsdf(loader: Loader, node) -> Material:
    """Parse a <bsdf> tree into a flattened Material."""
    if node.tag == "ref":
        m = _deref(loader, node)
        if not isinstance(m, Material):
            raise SceneLoadError(f"<ref id={node.get('id')!r}> is not a bsdf")
        return m

    typ = loader.attr(node, "type", "")
    scale_attr = node.get("scale")
    inner_bsdfs = [c for c in node if c.tag in ("bsdf", "ref")]

    if typ in ("twosided", "two_sided"):
        m = load_bsdf(loader, inner_bsdfs[0])
        m2 = copy.copy(m)
        m2.twosided = True
        return m2
    if typ == "mask":
        m = load_bsdf(loader, inner_bsdfs[0])
        m2 = copy.copy(m)
        for c in node:
            if c.tag in ("texture", "spectrum") \
                    and c.get("name") in ("opacity", "alpha", "mask"):
                m2.opacity = load_texture(loader, c)
        return m2
    if typ == "normalmap":
        m = load_bsdf(loader, inner_bsdfs[0])
        m2 = copy.copy(m)
        for c in node:
            if c.tag == "texture":
                m2.normalmap = load_texture(loader, c)
        return m2
    if (typ == "" and scale_attr is not None and inner_bsdfs) \
            or typ == "scale":
        # <bsdf scale=".1"> / <bsdf type="scale"> wrapper
        m = load_bsdf(loader, inner_bsdfs[0])
        m2 = copy.copy(m)
        s = loader.number(scale_attr) if scale_attr is not None else 1.0
        for c in node:
            if c.get("name") == "scale" and c.tag == "spectrum":
                sub = load_spectrum(loader, c)
                if isinstance(sub, UniformSpectrum):
                    s *= sub.value
                else:
                    loader.warn("non-constant bsdf scale spectrum "
                                "approximated by its mean")
                    s *= sub.power() / max(
                        sub.krange()[1] - sub.krange()[0], 1e-30)
            elif c.get("name") == "scale" and c.tag == "float":
                s *= loader.number(c.get("value"))
            elif c.get("name") == "scale" and c.tag == "texture":
                tex = load_texture(loader, c)
                loader.warn("textured bsdf scale approximated by its mean")
                s *= float(_rasterize_texture(
                    tex, *np.meshgrid(np.linspace(0, 1, 16),
                                      np.linspace(0, 1, 16))).mean())
        m2.scale = m.scale * s
        return m2

    named = loader.named_children(node)
    if typ == "diffuse":
        refl = None
        for c in node:
            if c.get("name") == "reflectance":
                refl = load_texture(loader, c)
        if refl is None:
            raise SceneLoadError("diffuse bsdf needs reflectance")
        return Material(bsdf=DiffuseBSDF(reflectance=refl),
                        name=node.get("id", ""))
    if typ == "dielectric":
        b = DielectricBSDF()
        for c in node:
            nm = c.get("name")
            if c.tag == "spectrum" and nm == "IOR":
                b.ior = _as_complex_spectrum(load_spectrum(loader, c))
            elif c.tag == "spectrum" and nm == "extIOR":
                b.ext_ior = _as_complex_spectrum(load_spectrum(loader, c))
            elif c.tag == "spectrum" and nm == "reflection_scale":
                b.reflection_scale = load_spectrum(loader, c)
            elif c.tag == "spectrum" and nm == "transmission_scale":
                b.transmission_scale = load_spectrum(loader, c)
        if b.ior is None:
            raise SceneLoadError("dielectric bsdf needs IOR")
        return Material(bsdf=b, name=node.get("id", ""))
    if typ == "surface_spm":
        b = SpmBSDF()
        for c in node:
            nm = c.get("name")
            if c.tag == "spectrum" and nm == "IOR":
                b.ior = _as_complex_spectrum(load_spectrum(loader, c))
            elif c.tag == "spectrum" and nm == "extIOR":
                b.ext_ior = _as_complex_spectrum(load_spectrum(loader, c))
            elif c.tag == "spectrum" and nm == "reflection_scale":
                b.reflection_scale = load_spectrum(loader, c)
            elif c.tag == "spectrum" and nm == "transmission_scale":
                b.transmission_scale = load_spectrum(loader, c)
            elif c.tag == "surface_profile":
                b.profile = load_profile(loader, c)
        if b.ior is None:
            raise SceneLoadError("surface_spm bsdf needs IOR")
        return Material(bsdf=b, name=node.get("id", ""))
    if typ == "composite":
        bins = []
        for c in node:
            if c.tag == "bin":
                lo, hi = parse_range(loader.subst(c.get("wavelength_range")))
                kmin = TWO_PI / hi.value
                kmax = TWO_PI / lo.value
                sub = [x for x in c if x.tag in ("bsdf", "ref")]
                if sub:
                    bins.append((kmin, kmax, load_bsdf(loader, sub[0])))
        return Material(bsdf=CompositeBSDF(bins=bins),
                        name=node.get("id", ""))
    raise SceneLoadError(f"unsupported bsdf type {typ!r}")


def _as_complex_spectrum(s):
    if isinstance(s, ComplexSpectrum):
        return s
    if isinstance(s, UniformSpectrum):
        return ComplexUniformSpectrum(complex(s.value, 0.0))
    raise SceneLoadError(f"expected complex IOR spectrum, got {type(s)}")


# --------------------------------------------------------------------------
# responses / tonemaps / film / sensors
# --------------------------------------------------------------------------

def load_tonemap(loader: Loader, node) -> Tonemap:
    typ = loader.attr(node, "type", "linear")
    tm = Tonemap(type=typ)
    for c in node:
        if c.tag == "range":
            lo, hi = parse_range(loader.subst(c.get("value")))
            tm.db_min, tm.db_max = lo.value, hi.value
        elif c.tag == "string" and c.get("name") == "colourmap":
            tm.colourmap = loader.subst(c.get("value"))
        elif c.tag == "float" and c.get("name") == "gamma":
            tm.gamma = loader.number(c.get("value"))
        elif c.tag == "float" and c.get("name") == "scale":
            tm.scale = loader.number(c.get("value"))
    return tm


def load_response(loader: Loader, node) -> Response:
    typ = loader.attr(node, "type", "RGB")
    r = Response(type=typ)
    if typ == "RGB":
        r.colourspace = "sRGB"
        r.white_point = "D65"
    for c in node:
        nm = c.get("name")
        if c.tag == "string" and nm == "colourspace":
            cs = loader.subst(c.get("value"))
            r.colourspace = {"CIE": "CIE"}.get(cs, cs)
        elif c.tag == "string" and nm == "white_point":
            r.white_point = loader.subst(c.get("value"))
        elif c.tag == "spectrum":
            if typ == "multichannel":
                r.channel_spectra.append(load_spectrum(loader, c))
            else:
                r.spectrum = load_spectrum(loader, c)
        elif c.tag == "tonemap":
            r.tonemap = load_tonemap(loader, c)
    return r


def load_film(loader: Loader, node):
    props = _get_props(loader, node)
    response = None
    for c in node:
        if c.tag == "response":
            response = load_response(loader, c)
    return dict(width=int(props.get("width", 256)),
                height=int(props.get("height", props.get("width", 256))),
                rfilter_scale=float(props.get("rfilter_scale", 1.0)),
                response=response or Response())


def load_sensor(loader: Loader, node):
    typ = loader.attr(node, "type", "perspective")
    props = _get_props(loader, node)
    film = dict(width=256, height=256, rfilter_scale=1.0,
                response=Response())
    for c in node:
        if c.tag == "film":
            film = load_film(loader, c)
    tw = _to_world(loader, node)
    def flag(name):
        # boolean sensor flags appear both as child props and as tag
        # attributes (<sensor polarimetric="true">)
        if name in props:
            return bool(props[name])
        v = loader.subst(node.get(name) or "")
        return v.strip().lower() in ("true", "1", "yes")

    common = dict(
        width=film["width"], height=film["height"],
        rfilter_scale=film["rfilter_scale"], response=film["response"],
        samples=int(props.get("samples", 16)),
        ray_trace_only=flag("ray_trace_only"),
        polarimetric=flag("polarimetric"),
        to_world=tw.m, id=node.get("id", typ))
    if typ == "perspective":
        return PerspectiveSensor(fov=props.get("fov", math.radians(45)),
                                 **common)
    if typ == "virtual_plane":
        extent = props.get("extent", [1.0, 1.0])
        if np.isscalar(extent):
            extent = [extent, extent]
        return VirtualPlaneSensor(extent=tuple(extent),
                                  alpha=props.get("alpha",
                                                  math.radians(0.001)),
                                  **common)
    raise SceneLoadError(f"unsupported sensor type {typ!r}")


# --------------------------------------------------------------------------
# shapes & emitters
# --------------------------------------------------------------------------

def load_emitter(loader: Loader, node, shape=None):
    typ = loader.attr(node, "type", "")
    props = _get_props(loader, node)
    spec = None
    for c in node:
        if c.tag == "spectrum":
            spec = load_spectrum(loader, c)
    pse = float(props.get("phase_space_extent_scale", 1.0))
    tw = _to_world(loader, node)
    if typ == "area":
        return AreaEmitter(spectrum=spec, phase_space_extent_scale=pse,
                           id=node.get("id", "area"))
    if typ == "point":
        pos = np.array(props.get("position", [0, 0, 0.0]))
        pos = tw.apply_point(pos[None])[0]
        return PointEmitter(spectrum=spec, position=pos,
                            phase_space_extent_scale=pse,
                            id=node.get("id", "point"))
    if typ == "spot":
        M = tw.m
        pos = M[:3, 3].copy()
        d = M[:3, 2].copy()
        return SpotEmitter(
            spectrum=spec, position=pos, direction=d / np.linalg.norm(d),
            beam_width=float(props.get("beam_width", math.radians(10))),
            cutoff=float(props.get("cutoff_angle", math.radians(20))),
            phase_space_extent_scale=pse, id=node.get("id", "spot"))
    if typ == "directional":
        M = tw.m
        d = M[:3, 2].copy()
        return DirectionalEmitter(
            spectrum=spec, direction=d / np.linalg.norm(d),
            phase_space_extent_scale=pse, id=node.get("id", "directional"))
    raise SceneLoadError(f"unsupported emitter type {typ!r}")


def load_shape(loader: Loader, node, scene: Scene):
    typ = loader.attr(node, "type", "")
    props = _get_props(loader, node)
    tw = _to_world(loader, node)
    mesh_scale = float(props.get("scale", loader.mesh_scale)) \
        if typ in ("ply", "obj") else 1.0

    material = None
    emitter = None
    for c in node:
        if c.tag in ("bsdf", "ref"):
            material = load_bsdf(loader, c)
        elif c.tag == "emitter":
            emitter = load_emitter(loader, c)

    if material is None:
        material = Material(bsdf=None, name="null")

    if typ == "rectangle":
        if "p" in props:
            # explicit origin + edge-vector form
            p = np.asarray(props["p"], np.float64)
            xv = np.asarray(props.get("x", [1.0, 0, 0]), np.float64)
            yv = np.asarray(props.get("y", [0, 1.0, 0]), np.float64)
            verts = np.stack([p, p + xv, p + xv + yv, p + yv])
            uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1.0]])
            idx = np.array([[0, 1, 2], [2, 3, 0]])
            soup = mesh_mod.build_soup(verts, idx, None, uvs, tw)
        else:
            soup = mesh_mod.rectangle(props.get("length", 1.0), tw)
    elif typ == "cube":
        soup = mesh_mod.cube(props.get("length", 1.0), tw)
    elif typ == "sphere":
        soup = mesh_mod.sphere(props.get("center", [0, 0, 0]),
                               props.get("radius", 1.0), tw,
                               tessellation=int(props.get("tessellation",
                                                          20)))
    elif typ == "cylinder":
        soup = mesh_mod.cylinder(props.get("p0", [0, 0, 0]),
                                 props.get("p1", [0, 0, 1]),
                                 props.get("radius", 1.0), tw,
                                 phi_tessellation=int(
                                     props.get("tessellation", 20)))
    elif typ == "prism":
        soup = mesh_mod.prism(props.get("length", 1.0),
                              props.get("height", 1.0),
                              props.get("angle", math.radians(60)), tw)
    elif typ == "lens":
        soup = mesh_mod.lens(props.get("center", [0, 0, 0]),
                             props.get("radius", 1.0),
                             props.get("R1", 0.0), props.get("R2", 0.0),
                             props.get("thickness", 1e-4), tw,
                             tessellation=int(props.get("tessellation",
                                                        35)))
    elif typ in ("ply", "obj"):
        path = props.get("path")
        fp = loader.resolve_path(path)
        scale_t = Transform.scale([mesh_scale] * 3)
        face_normals = bool(props.get("face_normals", False))
        if typ == "ply":
            v, f, n, uv = ply_mod.load_ply(fp)
            soup = mesh_mod.build_soup(v, f, None if face_normals else n,
                                       uv, tw @ scale_t)
        else:
            pos, n, uv = obj_mod.load_obj(fp)
            soup = mesh_mod.build_soup_from_corners(
                pos, None if face_normals else n, uv, tw @ scale_t)
    else:
        raise SceneLoadError(f"unsupported shape type {typ!r}")

    sh = Shape(soup=soup, material=material, emitter=emitter,
               id=node.get("id", typ))
    scene.shapes.append(sh)
    if emitter is not None:
        scene.emitters.append(emitter)


# --------------------------------------------------------------------------
# top level
# --------------------------------------------------------------------------

def load_scene_xml(path: str, defines: dict | None = None,
                   mesh_scale: float = 1.0) -> Scene:
    scene_dir = os.path.dirname(os.path.abspath(path))
    loader = Loader(scene_dir, defines, mesh_scale)
    root = _parse_xml_file(path)
    if root.tag != "scene":
        raise SceneLoadError("root element must be <scene>")

    # collect defaults first (CLI -D overrides them)
    for c in root:
        if c.tag == "default":
            name = c.get("name")
            if name not in loader.defines:
                loader.defines[name] = c.get("value")

    scene = Scene()
    _load_elements(loader, root, scene)

    if not scene.sensors:
        raise SceneLoadError("scene has no enabled sensors")
    return scene


def _load_elements(loader: Loader, root, scene: Scene):
    for c in root:
        if c.tag == "default":
            continue
        if c.tag == "include":
            rel = loader.subst(c.get("path"))
            sub = _parse_xml_file(os.path.join(loader.scene_dir, rel))
            _load_elements(loader, sub, scene)
            continue
        if not _enabled(loader, c):
            continue
        try:
            if c.tag == "integrator":
                props = _get_props(loader, c)
                scene.integrator = IntegratorConfig(
                    type=loader.attr(c, "type", "plt_path"),
                    max_depth=int(props.get("max_depth", 16)),
                    russian_roulette=bool(props.get("russian_roulette",
                                                    True)),
                    mis=bool(props.get("MIS", True)),
                    fsd=bool(props.get("FSD", True)))
            elif c.tag == "sensor":
                scene.sensors.append(load_sensor(loader, c))
            elif c.tag == "bsdf":
                m = load_bsdf(loader, c)
                if c.get("id"):
                    loader.registry[c.get("id")] = m
            elif c.tag == "texture":
                t = load_texture(loader, c)
                if c.get("id"):
                    loader.registry[c.get("id")] = t
            elif c.tag == "spectrum":
                s = load_spectrum(loader, c)
                if c.get("id"):
                    loader.registry[c.get("id")] = s
            elif c.tag == "shape":
                load_shape(loader, c, scene)
            elif c.tag == "emitter":
                scene.emitters.append(load_emitter(loader, c))
            else:
                loader.warn(f"unhandled top-level element <{c.tag}>")
        except SceneLoadError as e:
            # missing assets (git-lfs stubs) degrade to warnings for shapes
            if c.tag == "shape":
                loader.warn(f"shape skipped: {e}")
            else:
                raise
    return scene
