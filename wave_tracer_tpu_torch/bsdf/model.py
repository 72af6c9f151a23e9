"""Host-side material model (flattened BSDF trees).

Port of wave_tracer_tpu/bsdf/model.py: a `Material` is a base lobe
(diffuse, dielectric, surface_spm, a composite of child materials by
wavenumber band, or None for a null/passthrough surface) plus wrapper
attributes (twosided, scale, an opacity mask and a normal map).
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
class DielectricBSDF:
    """Smooth dielectric interface: Fresnel reflection or refraction."""
    ior: ComplexSpectrum = None            # material η(k)
    ext_ior: Optional[ComplexSpectrum] = None
    reflection_scale: Optional[Spectrum] = None
    transmission_scale: Optional[Spectrum] = None


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
class CompositeBSDF:
    """Wavelength-binned BSDF switch: the first bin [kmin, kmax) that
    holds k selects its child material; outside every bin, no
    interaction (null)."""
    bins: list = field(default_factory=list)   # [(kmin, kmax, Material)]


@dataclass
class Material:
    """A flattened BSDF tree: base lobe + wrapper attributes."""
    bsdf: object = None                   # Diffuse/Dielectric/Spm/Composite
    twosided: bool = False
    scale: float = 1.0
    opacity: Optional[Texture] = None     # mask wrapper
    normalmap: Optional[Texture] = None   # normalmap wrapper
    name: str = ""
