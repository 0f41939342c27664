"""Device selection for the port's entry points.

Every entry point takes ``device=None``; that means the card. A caller
who wants the CPU (the tests, a host-only run) asks for it by name. A
missing card is an error, never a quiet fall back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the host")
    return dev
