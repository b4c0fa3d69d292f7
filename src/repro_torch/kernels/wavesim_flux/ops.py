"""Public flux op, from :mod:`repro.kernels.wavesim_flux.ops`.

Routing is by the tensors' device and nothing else: CUDA tensors go to the
hand-written kernel (:mod:`.kernel`), CPU tensors to its plain version
(:mod:`.ref`).  There is no fallback: a CUDA call the kernel cannot take
raises.  The JAX op pads E to a tile with wrapped rows and repairs the
seam after the call; the kernel takes the wrapped neighbour by index, so
any E goes straight in.  There is no ``interpret`` flag.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def flux1d(hi: torch.Tensor, lo: torch.Tensor, alpha: float = 0.5
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """hi, lo [E, T] -> (fhi, flo) [E, T] in the inputs' dtype, periodic
    along E: fhi[i] = alpha (lo[i+1] - hi[i]), flo[i] = alpha (hi[i-1] -
    lo[i])."""
    if hi.dim() != 2 or hi.shape != lo.shape:
        raise ValueError(f"hi and lo must be [E, T] of one shape, got "
                         f"{tuple(hi.shape)} and {tuple(lo.shape)}")
    if hi.device.type == "cuda":
        return kernel.flux1d_cuda(hi.contiguous(), lo.contiguous(), alpha)
    return ref.flux1d_ref(hi, lo, alpha)
