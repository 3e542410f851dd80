"""Device selection for the port's entry points.

The port runs on the card. ``resolve(None)`` is ``cuda`` and raises when no
CUDA device is present; the plain-PyTorch CPU path runs only when a caller
asks for it by name (``device="cpu"``), as the parity tests do. There is
no silent fallback from one to the other.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default (pass device='cpu' to run the plain PyTorch path)")
    return dev
