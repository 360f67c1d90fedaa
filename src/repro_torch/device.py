"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller asks for it: a missing card is an error, never a quiet fallback.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is present (checked per call, never cached)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the host")
    return dev
