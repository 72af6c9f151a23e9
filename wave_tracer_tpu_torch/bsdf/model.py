"""Host-side material model (flattened BSDF trees).

Port of wave_tracer_tpu/bsdf/model.py for the lobes the port renders: a
`Material` is a base lobe (diffuse, or None for a null/passthrough
surface) plus wrapper attributes. Opacity masks and normal maps are kept as
fields so a scene that sets them fails loudly at bake time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from wave_tracer_tpu_torch.texture.texture import Texture


@dataclass
class DiffuseBSDF:
    reflectance: Texture = None


@dataclass
class Material:
    """A flattened BSDF tree: base lobe + wrapper attributes."""
    bsdf: object = None                   # DiffuseBSDF or None (null)
    twosided: bool = False
    scale: float = 1.0
    opacity: Optional[Texture] = None     # mask wrapper (not ported yet)
    normalmap: Optional[Texture] = None   # normalmap wrapper (not ported)
    name: str = ""
