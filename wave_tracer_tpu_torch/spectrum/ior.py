"""Material data: refractive indices and measured emission spectra.

Port of wave_tracer_tpu/spectrum/ior.py:
* refractiveindex.info YAML files (``data/ior/<name>.yml``): "tabulated
  nk/n/k" and Sellmeier "formula 1/2" entries → complex IOR η = n + iκ;
* measured lamp spectra (``data/emission/<name>.yml``, "tabulated
  intensity"): values at λ become the density at k = 2π/λ with no
  Jacobian, and zero guard nodes are added at both ends;
* ITU-R P.2040-2 Table 3 building materials: relative permittivity
  εr = a·f^b and conductivity σ = c·f^d S/m (f in GHz),
  η = sqrt(εr − i·σ/(ε0·ω)).
The data files are looked up under DATA_SEARCH_PATHS (a file that is a
git-lfs pointer does not count); a name found nowhere raises
FileNotFoundError. PyYAML is imported only when a file is parsed.
"""

from __future__ import annotations

import os

import numpy as np

from wave_tracer_tpu_torch.spectrum.spectra import (ComplexSpectrum,
                                                    ComplexTabulatedSpectrum,
                                                    PiecewiseLinearSpectrum,
                                                    TWO_PI)

EPS0 = 8.8541878128e-12   # F/m
C_LIGHT = 299792458.0

# roots searched in order for data files ("ior/<name>.yml",
# "emission/<name>.yml"); callers may add their own
DATA_SEARCH_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "data"),
]


def resolve_data(relpath: str) -> str | None:
    """The first file `relpath` under DATA_SEARCH_PATHS that is not a
    git-lfs pointer, or None."""
    for root in DATA_SEARCH_PATHS:
        p = os.path.join(root, relpath)
        if os.path.isfile(p):
            with open(p, "rb") as fh:
                if fh.read(24).startswith(b"version https://git-lfs"):
                    continue
            return p
    return None


def _sellmeier_n(lam_um: np.ndarray, coeffs: list[float],
                 formula: int) -> np.ndarray:
    """n(λ) from refractiveindex.info formula 1/2 (Sellmeier).
    formula 1 lists C terms as sqrt; formula 2 lists them squared."""
    c = list(coeffs) + [0.0] * (7 - len(coeffs))
    A, B1, C1, B2, C2, B3, C3 = c[:7]
    if formula == 1:
        C1, C2, C3 = C1 ** 2, C2 ** 2, C3 ** 2
    l2 = lam_um ** 2

    def term(B, C):
        return B * l2 / np.where(np.abs(l2 - C) < 1e-12, 1e-12, l2 - C)
    n2 = 1.0 + A + term(B1, C1) + term(B2, C2) + term(B3, C3)
    return np.sqrt(np.maximum(n2, 0.0))


def _parse_tabulated(block: str, ncols: int) -> np.ndarray:
    rows = []
    for line in block.strip().splitlines():
        parts = line.split()
        if len(parts) >= ncols:
            rows.append([float(x) for x in parts[:ncols]])
    return np.asarray(rows, np.float64)


def load_rii_ior(path: str) -> ComplexTabulatedSpectrum:
    """Load a refractiveindex.info-style IOR YAML into η(k) = n + iκ."""
    import yaml
    with open(path) as f:
        db = yaml.safe_load(f)
    lam_n, n_vals = [], []      # wavelength [µm] → n
    lam_k, k_vals = [], []      # wavelength [µm] → κ
    for entry in db.get("DATA", []):
        typ = entry.get("type", "")
        if typ.startswith("formula"):
            formula = int(typ.split()[-1])
            lr = [float(x) for x in str(entry["wavelength_range"]).split()]
            coeffs = [float(x) for x in str(entry["coefficients"]).split()]
            lam = np.linspace(lr[0], lr[1],
                              max(2, int((lr[1] - lr[0]) / 0.005)))
            lam_n += list(lam)
            n_vals += list(_sellmeier_n(lam, coeffs, formula))
        elif typ.startswith("tabulated"):
            kind = typ.split()[-1]          # 'nk' | 'n' | 'k'
            ncols = 3 if kind == "nk" else 2
            data = _parse_tabulated(entry["data"], ncols)
            if kind in ("nk", "n"):
                lam_n += list(data[:, 0])
                n_vals += list(data[:, 1])
            if kind == "nk":
                lam_k += list(data[:, 0])
                k_vals += list(data[:, 2])
            elif kind == "k":
                lam_k += list(data[:, 0])
                k_vals += list(data[:, 1])
    if not lam_n:
        raise ValueError(f"no refractive-index data in {path}")
    lam_n = np.asarray(lam_n)
    n_vals = np.asarray(n_vals)
    # resample κ onto the n wavelength grid (0 where absent)
    if lam_k:
        lk = np.asarray(lam_k)
        kv = np.asarray(k_vals)
        o = np.argsort(lk)
        kappa = np.interp(lam_n, lk[o], kv[o], left=kv[o][0],
                          right=kv[o][-1])
    else:
        kappa = np.zeros_like(n_vals)
    k_nodes = TWO_PI / (lam_n * 1e-6)
    return ComplexTabulatedSpectrum(k_nodes=k_nodes, n=n_vals, kappa=kappa)


def load_material_ior(name: str) -> ComplexTabulatedSpectrum:
    """Resolve ``<spectrum material="Au"/>`` to data/ior/<name>.yml."""
    p = resolve_data(os.path.join("ior", name + ".yml"))
    if p is None:
        raise FileNotFoundError(f"IOR material '{name}' not found")
    return load_rii_ior(p)


def load_emission_spectrum(name: str) -> PiecewiseLinearSpectrum:
    """Resolve ``<spectrum emitter="..."/>`` to data/emission/<name>.yml."""
    p = resolve_data(os.path.join("emission", name + ".yml"))
    if p is None:
        raise FileNotFoundError(f"emission spectrum '{name}' not found")
    import yaml
    with open(p) as f:
        db = yaml.safe_load(f)
    ks, vs = [], []
    for entry in db.get("DATA", []):
        if str(entry.get("type", "")).startswith("tabulated"):
            data = _parse_tabulated(entry["data"], 2)
            ks += list(TWO_PI / (data[:, 0] * 1e-9))   # λ given in nm
            vs += list(data[:, 1])
    if len(ks) < 2:
        raise ValueError(f"no tabulated emission data in {p}")
    ks = np.asarray(ks)
    vs = np.asarray(vs)
    o = np.argsort(ks)
    ks, vs = ks[o], vs[o]
    # zero guard nodes just outside the range
    dk0 = 0.01 * (ks[1] - ks[0])
    dk1 = 0.01 * (ks[-1] - ks[-2])
    ks = np.concatenate([[max(ks[0] - max(dk0, 1e-6), 0.0)], ks,
                         [ks[-1] + max(dk1, 1e-6)]])
    vs = np.concatenate([[0.0], vs, [0.0]])
    return PiecewiseLinearSpectrum(k_nodes=ks, values=vs)


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
