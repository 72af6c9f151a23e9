"""Sensor spectral responses.

Port of wave_tracer_tpu/sensor/response.py for the RGB and XYZ responses:
paths accumulate in XYZ (CIE CMFs evaluated on the device); the RGB
conversion belongs to image output, which is not ported yet. Monochromatic
and multichannel responses are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from wave_tracer_tpu_torch.spectrum import cie
from wave_tracer_tpu_torch.spectrum.bake import xyz_response_dev
from wave_tracer_tpu_torch.spectrum.spectra import Spectrum

_PORTED = ("RGB", "XYZ")


def _require_ported(kind):
    if kind not in _PORTED:
        raise NotImplementedError(f"{kind} responses are not ported yet")


@dataclass
class Response:
    """type: 'RGB' | 'XYZ' (ported)."""
    type: str = "RGB"
    colourspace: str = "sRGB"
    white_point: str = "D65"

    @property
    def channels(self) -> int:
        _require_ported(self.type)
        return 3

    def sensitivity_spectrum(self) -> Spectrum:
        """Total (channel-summed) sensitivity for importance sampling."""
        _require_ported(self.type)
        return _CMFSumSpectrum()

    def sensitivities(self, k, spec_table=None, spec_rows=None):
        """Per-channel sensitivity at wavenumber k (...,) → (..., 3)."""
        _require_ported(self.type)
        return xyz_response_dev(k)


class _CMFSumSpectrum(Spectrum):
    """x̄+ȳ+z̄ as a host spectrum (sampling product with emitter spectra)."""

    def eval(self, k):
        lam_nm = 2.0 * np.pi / np.asarray(k) * 1e9
        x, y, z = cie.xyz_cmf(lam_nm)
        return x + y + z

    def krange(self):
        return (2 * np.pi / (cie.LAMBDA_MAX_NM * 1e-9),
                2 * np.pi / (cie.LAMBDA_MIN_NM * 1e-9))
