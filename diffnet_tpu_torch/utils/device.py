"""Where the port's entry points run.

Every entry point (``Trainer``, the linear solvers, stencil extraction,
continuation) takes ``device="cuda"`` by default: the port is written for
the card, and a caller who wants the CPU says so. Without CUDA the default
raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device, caller: str) -> torch.device:
    """``torch.device(device)``; RuntimeError for a CUDA device when CUDA is
    not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device={str(device)!r}): CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device
