"""Complex refractive indices of ITU-R P.2040-2 building materials.

Port of `ITUComplexSpectrum` of wave_tracer_tpu/spectrum/ior.py, with its
own copy of the standard's Table 3: relative permittivity εr = a·f^b
and conductivity σ = c·f^d S/m (f in GHz), η = sqrt(εr − i·σ/(ε0·ω)).
The JAX module's loaders of refractiveindex.info files and lamp spectra read
data files outside the repository and are not ported.
"""

from __future__ import annotations

import numpy as np

from wave_tracer_tpu_torch.spectrum.spectra import ComplexSpectrum, TWO_PI

EPS0 = 8.8541878128e-12   # F/m
C_LIGHT = 299792458.0

# ITU-R P.2040-2 Table 3 (public standard data): material →
# list of (a, b, c, d, f_min_GHz, f_max_GHz).
ITU_P2040_TABLE3 = {
    "vacuum":            [(1.0, 0.0, 0.0, 0.0, 0.0, 1e9)],
    "concrete":          [(5.24, 0.0, 0.0462, 0.7822, 1.0, 100.0)],
    "brick":             [(3.91, 0.0, 0.0238, 0.16, 1.0, 40.0)],
    "plasterboard":      [(2.73, 0.0, 0.0085, 0.9395, 1.0, 100.0)],
    "wood":              [(1.99, 0.0, 0.0047, 1.0718, 0.001, 100.0)],
    "glass":             [(6.31, 0.0, 0.0036, 1.3394, 0.1, 100.0),
                          (5.79, 0.0, 0.0004, 1.658, 220.0, 450.0)],
    "ceiling_board":     [(1.48, 0.0, 0.0011, 1.0750, 1.0, 100.0),
                          (1.52, 0.0, 0.0029, 1.029, 220.0, 450.0)],
    "chipboard":         [(2.58, 0.0, 0.0217, 0.7800, 1.0, 100.0)],
    "plywood":           [(2.71, 0.0, 0.33, 0.0, 1.0, 40.0)],
    "marble":            [(7.074, 0.0, 0.0055, 0.9262, 1.0, 60.0)],
    "floorboard":        [(3.66, 0.0, 0.0044, 1.3515, 50.0, 100.0)],
    "metal":             [(1.0, 0.0, 1e7, 0.0, 1.0, 100.0)],
    "very_dry_ground":   [(3.0, 0.0, 0.00015, 2.52, 1.0, 10.0)],
    "medium_dry_ground": [(15.0, -0.1, 0.035, 1.63, 1.0, 10.0)],
    "wet_ground":        [(30.0, -0.4, 0.15, 1.30, 1.0, 10.0)],
}


class ITUComplexSpectrum(ComplexSpectrum):
    """η(k) of an ITU-R P.2040-2 material; 0 outside the table's bands.
    The conductivity term makes Im η ≤ 0."""

    def __init__(self, name: str):
        if name not in ITU_P2040_TABLE3:
            raise KeyError(f"unknown ITU material '{name}'")
        self.name = name
        self.params = ITU_P2040_TABLE3[name]

    def eval(self, k):
        k = np.atleast_1d(np.asarray(k, np.float64))
        out = np.zeros(k.shape, np.complex128)
        f_ghz = C_LIGHT * k / TWO_PI / 1e9
        omega = k * C_LIGHT
        for a, b, c, d, flo, fhi in self.params:
            sel = (f_ghz >= flo) & (f_ghz <= fhi) & (out == 0)
            fsafe = np.maximum(f_ghz, 1e-30)
            er = a * (np.power(fsafe, b) if b != 0 else 1.0)
            sigma = c * (np.power(fsafe, d) if d != 0 else 1.0)
            rel_sigma = -sigma / (EPS0 * np.maximum(omega, 1e-30))
            eta = np.sqrt(er + 1j * rel_sigma)
            out = np.where(sel, eta, out)
        return out
