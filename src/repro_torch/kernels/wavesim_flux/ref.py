"""Plain PyTorch version of the 1-D face-flux exchange, from
:mod:`repro.kernels.wavesim_flux.ref`: the CPU path of :mod:`.ops` and
what the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def flux1d_ref(hi: torch.Tensor, lo: torch.Tensor,
               alpha: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """hi/lo: [E, T] element high/low face traces (periodic neighbors).

    Returns (flux_hi, flux_lo): alpha * (neighbor_trace - own_trace).
    """
    nb_hi = torch.roll(lo, -1, dims=0)   # next element's low face
    nb_lo = torch.roll(hi, 1, dims=0)    # previous element's high face
    return alpha * (nb_hi - hi), alpha * (nb_lo - lo)
