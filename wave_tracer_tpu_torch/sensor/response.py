"""Sensor spectral responses: RGB / XYZ / monochromatic / multichannel.

Port of wave_tracer_tpu/sensor/response.py. A response maps a path's
wavenumber to per-channel sensitivities: RGB and XYZ responses accumulate
in XYZ (CIE CMFs evaluated on the device; an RGB response's XYZ→RGB
matrix, `develop_matrix`, is applied when the image is written),
monochromatic and multichannel responses read their baked sensitivity
spectra. The response also gives the total sensitivity spectrum of
spectral importance sampling, and carries the sensor's tonemap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from wave_tracer_tpu_torch.spectrum import cie
from wave_tracer_tpu_torch.spectrum.bake import xyz_response_dev
from wave_tracer_tpu_torch.spectrum.spectra import (K_VISIBLE_MAX,
                                                    K_VISIBLE_MIN, Spectrum,
                                                    UniformSpectrum)


@dataclass
class Response:
    """type: 'RGB' | 'XYZ' | 'monochromatic' | 'multichannel'."""
    type: str = "RGB"
    colourspace: str = "sRGB"
    white_point: str = "D65"
    spectrum: Optional[Spectrum] = None        # monochromatic sensitivity
    channel_spectra: list = field(default_factory=list)  # multichannel
    tonemap: object = None                     # sensor.tonemap.Tonemap

    @property
    def channels(self) -> int:
        if self.type in ("RGB", "XYZ"):
            return 3
        if self.type == "multichannel":
            return max(len(self.channel_spectra), 1)
        if self.type == "monochromatic":
            return 1
        raise ValueError(self.type)

    def sensitivity_spectrum(self) -> Spectrum:
        """Total (channel-summed) sensitivity for importance sampling."""
        if self.type in ("RGB", "XYZ"):
            return _CMFSumSpectrum()
        if self.type == "monochromatic":
            return self.spectrum if self.spectrum is not None \
                else UniformSpectrum(1.0, K_VISIBLE_MIN, K_VISIBLE_MAX)
        if self.type == "multichannel":
            return _SumSpectrum(self.channel_spectra)
        raise ValueError(self.type)

    def develop_matrix(self) -> Optional[np.ndarray]:
        """Channel mixing applied at develop (XYZ→RGB), or None."""
        if self.type == "RGB":
            return cie.xyz_to_rgb_matrix(self.colourspace, self.white_point)
        return None

    def sensitivities(self, k, spec_table=None, spec_rows=None):
        """Per-channel sensitivity at wavenumber k (...,) → (..., C).

        Monochromatic and multichannel responses look their baked spectra
        up in spec_table at rows spec_rows (ints); a discrete
        monochromatic sensitivity accepts every path (the spectral sampler
        only proposes its lines), as does any response without a table."""
        if self.type in ("RGB", "XYZ"):
            return xyz_response_dev(k)
        if self.type == "monochromatic":
            if self.spectrum is None or self.spectrum.is_discrete \
                    or spec_table is None:
                return torch.ones(k.shape + (1,), dtype=torch.float32,
                                  device=k.device)
            return spec_table.eval(_row(spec_rows[0], k), k)[..., None]
        if self.type == "multichannel":
            if spec_table is None:
                return torch.ones(k.shape + (self.channels,),
                                  dtype=torch.float32, device=k.device)
            return torch.stack([spec_table.eval(_row(r, k), k)
                                for r in spec_rows], dim=-1)
        raise ValueError(self.type)


def _row(r, k):
    return torch.full(k.shape, int(r), dtype=torch.int32, device=k.device)


class _CMFSumSpectrum(Spectrum):
    """x̄+ȳ+z̄ as a host spectrum (sampling product with emitter spectra)."""

    def eval(self, k):
        lam_nm = 2.0 * np.pi / np.asarray(k) * 1e9
        x, y, z = cie.xyz_cmf(lam_nm)
        return x + y + z

    def krange(self):
        return (2 * np.pi / (cie.LAMBDA_MAX_NM * 1e-9),
                2 * np.pi / (cie.LAMBDA_MIN_NM * 1e-9))


class _SumSpectrum(Spectrum):
    """Σ of the channel spectra of a multichannel response."""

    def __init__(self, spectra):
        self.spectra = spectra

    def eval(self, k):
        out = np.zeros_like(np.asarray(k, np.float64))
        for s in self.spectra:
            out = out + s.eval(k)
        return out

    def krange(self):
        los, his = zip(*[s.krange() for s in self.spectra])
        return (min(los), max(his))
