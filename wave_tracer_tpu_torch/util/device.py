"""The port's device rule: its entry points run on the card unless the
caller asks for the CPU, and never fall back to the CPU by themselves."""

from __future__ import annotations

import torch


def card(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card "
                           "unless device='cpu' is asked for")
    return dev
