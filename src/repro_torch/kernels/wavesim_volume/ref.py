"""Plain PyTorch versions of the wavesim volume term, from
:mod:`repro.kernels.wavesim_volume.ref`: the op oracle (the core einsums),
and the plain version of the CUDA kernel on the kernel's own arguments,
which is the CPU path of :mod:`.ops` and what the kernel is held against
on the card."""
from __future__ import annotations

import torch

from repro_torch.core.primitives.wavesim import volume as _volume


def volume_ref(u: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """u: [elements, fields, 3, 3, 3] -> rhs, same shape."""
    return _volume(u, c)


def volume_kernel_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [R, 27] @ w [27, 27] summed in float32 (float64 for float64
    inputs) and returned in x's dtype, as the TPU kernel's
    ``preferred_element_type=float32`` product."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.matmul(x.to(ct), w.to(device=x.device, dtype=ct)).to(x.dtype)
