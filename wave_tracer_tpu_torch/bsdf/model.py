"""Host-side material model (flattened BSDF trees).

Port of wave_tracer_tpu/bsdf/model.py for the lobes the port renders: a
`Material` is a base lobe (diffuse, surface_spm, or None for a
null/passthrough surface) plus wrapper attributes. The dielectric and
composite lobes, opacity masks and normal maps are not ported yet; the
latter two are kept as fields so a scene that sets them fails loudly at
bake time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from wave_tracer_tpu_torch.spectrum.spectra import ComplexSpectrum, Spectrum
from wave_tracer_tpu_torch.texture.texture import Texture


@dataclass
class SurfaceProfile:
    """dirac | gaussian | fractal. Roughness optionally textured; direct
    (T, σh) parameterization for the gaussian σ and the fractal T."""
    type: str = "dirac"
    gamma: float = 3.0
    roughness: Optional[Texture] = None   # perceptual roughness texture
    T: Optional[float] = None             # mm² (fractal direct param)
    sigma: Optional[float] = None         # 1/mm (gaussian σ / fractal σ_h)


@dataclass
class DiffuseBSDF:
    reflectance: Texture = None


@dataclass
class SpmBSDF:
    """surface_spm: the wave BSDF (first-order small-perturbation scatter
    plus a Rayleigh-attenuated specular lobe)."""
    ior: ComplexSpectrum = None
    ext_ior: Optional[ComplexSpectrum] = None
    profile: SurfaceProfile = field(default_factory=SurfaceProfile)
    reflection_scale: Optional[Spectrum] = None
    transmission_scale: Optional[Spectrum] = None


@dataclass
class Material:
    """A flattened BSDF tree: base lobe + wrapper attributes."""
    bsdf: object = None                   # DiffuseBSDF, SpmBSDF or None
    twosided: bool = False
    scale: float = 1.0
    opacity: Optional[Texture] = None     # mask wrapper (not ported yet)
    normalmap: Optional[Texture] = None   # normalmap wrapper (not ported)
    name: str = ""
