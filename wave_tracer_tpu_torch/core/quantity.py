"""Unit-bearing quantity parsing for the scene dialect.

Port of wave_tracer_tpu/core/quantity.py. Scene attributes carry units
("19.75°", "10GHz", ".05mm", "5000K"); every quantity is converted at the
parse boundary to SI (metres, radians, Hz, Kelvin, seconds) and flows on
as a plain float. Expressions in parentheses ("(250/4) mm") go through
core/expr.py.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

from wave_tracer_tpu_torch.core.expr import evaluate

SPEED_OF_LIGHT = 299_792_458.0  # m/s

_LENGTH_UNITS = {
    "nm": 1e-9, "µm": 1e-6, "um": 1e-6, "mm": 1e-3, "cm": 1e-2,
    "dm": 1e-1, "m": 1.0, "km": 1e3,
}
_ANGLE_UNITS = {"°": math.pi / 180.0, "deg": math.pi / 180.0,
                "rad": 1.0, "mrad": 1e-3}
_FREQ_UNITS = {"Hz": 1.0, "kHz": 1e3, "KHz": 1e3, "MHz": 1e6,
               "GHz": 1e9, "THz": 1e12}
_TEMP_UNITS = {"K": 1.0}
_TIME_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0}


@dataclass(frozen=True)
class Quantity:
    """A parsed scalar with an SI-normalized value and a dimension tag."""
    value: float
    dim: str  # 'length'|'angle'|'frequency'|'temperature'|'time'|'dimensionless'

    def __float__(self):
        return float(self.value)


class QuantityError(ValueError):
    pass


def _split_value_and_unit(s: str) -> tuple[float, str]:
    """Split '(expr) unit' / 'number unit' / 'numberunit' into (value, unit)."""
    s = s.strip()
    if not s:
        raise QuantityError("empty quantity")
    if s[0] == "(":
        depth = 0
        for i, c in enumerate(s):
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
                if depth == 0:
                    return evaluate(s[: i + 1]), s[i + 1:].strip()
        raise QuantityError(f"unbalanced parens in {s!r}")
    m = re.match(r"[-+]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    if not m:
        raise QuantityError(f"no numeric value in {s!r}")
    return float(m.group(0)), s[m.end():].strip()


def parse_quantity(s: str) -> Quantity:
    """Parse a single quantity string into SI units.

    Length -> metres, angle -> radians, frequency -> Hz, temperature -> K,
    time -> seconds; a bare number is dimensionless.
    """
    val, unit = _split_value_and_unit(s)
    if unit == "":
        return Quantity(val, "dimensionless")
    if unit in _LENGTH_UNITS:
        return Quantity(val * _LENGTH_UNITS[unit], "length")
    if unit in _ANGLE_UNITS:
        return Quantity(val * _ANGLE_UNITS[unit], "angle")
    if unit in _FREQ_UNITS:
        return Quantity(val * _FREQ_UNITS[unit], "frequency")
    if unit in _TEMP_UNITS:
        return Quantity(val * _TEMP_UNITS[unit], "temperature")
    if unit in _TIME_UNITS:
        return Quantity(val * _TIME_UNITS[unit], "time")
    raise QuantityError(f"unknown unit {unit!r} in {s!r}")


def _split_top_level(s: str, sep: str) -> list[str]:
    """Split on `sep` at paren depth 0."""
    parts, depth, cur = [], 0, []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        if depth == 0 and s[i:i + len(sep)] == sep:
            parts.append("".join(cur))
            cur = []
            i += len(sep)
            continue
        cur.append(c)
        i += 1
    parts.append("".join(cur))
    return parts


def parse_quantity_vector(s: str) -> list[Quantity]:
    """Parse comma-separated quantities, e.g. '0cm, 1cm, 6.8cm'."""
    return [parse_quantity(p) for p in _split_top_level(s, ",") if p.strip()]


def parse_range(s: str) -> tuple[Quantity, Quantity]:
    """Parse 'a .. b' ranges, e.g. '300nm .. 800nm' or '$db_min .. $db_max'."""
    parts = _split_top_level(s, "..")
    if len(parts) != 2:
        raise QuantityError(f"not a range: {s!r}")
    return parse_quantity(parts[0]), parse_quantity(parts[1])


_COMPLEX_RE = re.compile(
    r"^\(\s*([-+]?[\d.eE+-]+)\s*,\s*([-+]?[\d.eE+-]+)i\s*\)$")


def parse_complex(s: str) -> complex:
    """Parse '(re, imi)' complex literals, e.g. '(1,100i)'."""
    s = s.strip()
    m = _COMPLEX_RE.match(s)
    if m:
        return complex(float(m.group(1)), float(m.group(2)))
    return complex(evaluate(s), 0.0)


def wavelength_m(q: Quantity) -> float:
    """Interpret a quantity as a vacuum wavelength in metres.

    Scenes specify wavelength either as a length ('.05mm', '400nm') or as a
    frequency ('10GHz', as radio coverage scenes give it).
    """
    if q.dim == "length":
        return q.value
    if q.dim == "frequency":
        return SPEED_OF_LIGHT / q.value
    if q.dim == "dimensionless":
        return q.value  # caller supplies implicit unit
    raise QuantityError(f"cannot interpret {q} as wavelength")


def wavenumber_from_wavelength_m(lambda_m: float) -> float:
    """k = 2*pi/lambda in rad/m (the framework's spectral variable)."""
    return 2.0 * math.pi / lambda_m
