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


def use_device(device) -> torch.device:
    """Make ``device`` this process's current CUDA device (a CPU device is
    left as it is).  The port's kernels run on the current device: their
    libraries set their limits on it when they load, and ``native.launch``
    refuses a tensor on any other.  So a process that proves on another card
    than the first, each rank of a multi-rank prove among them, calls this
    before its first kernel loads (``parallel/mesh.py:make_mesh`` does)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev
