"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``.  The CPU is used only when a caller
asks for it (the tests do); a CUDA request on a machine without a GPU
raises instead of quietly running somewhere else.  :func:`sm_count` is
the one place the port reads the card's SM count, which the persistent
and split schedules of its kernels are sized from.
"""
from __future__ import annotations

import torch

_SMS: dict[int, int] = {}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def sm_count(device: torch.device) -> int:
    """SMs of the CUDA ``device``, read once a device."""
    n = _SMS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device.index] = n
    return n
