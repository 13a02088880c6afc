"""Device resolution for the port's entry points.

The default device is ``"cuda"``.  There is no fallback: asking for a CUDA
device on a machine without one raises, so a run can never report numbers
from the CPU under the name of the card."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain tensor code on the host"
        )
    return dev
