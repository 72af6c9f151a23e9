"""The plain reference of the benchmark's `correct` (plain PyTorch, NumPy
and SciPy; nothing of the program).

Each module recomputes, from the configuration's own geometry and the
inputs that the program's timed calls were given, what those calls
should have returned. Every function takes `prec`: "f64" computes in
float64 (the reference), "tf32" rounds every input to TF32 (10 mantissa
bits) and computes in float32, the precision a tensor-core version of the
same arithmetic would use (the control that `correct` must reject).
"""

from __future__ import annotations

import torch


def tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits, nearest even), as a
    float32 tensor."""
    x = x.to(torch.float32).contiguous()
    b = x.view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def cast(x, prec):
    """An input at the precision `prec` computes in."""
    if prec == "f64":
        return x.to(torch.float64)
    if prec == "tf32":
        return tf32(x)
    raise ValueError(f"precision {prec!r}: f64 or tf32")
