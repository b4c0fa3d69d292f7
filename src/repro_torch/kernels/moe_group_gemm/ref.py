"""Plain PyTorch version of the grouped expert GEMM, from
:mod:`repro.kernels.moe_group_gemm.ref`, and of its backward's three
kernels.

What the op runs on CPU tensors and what ``chip_smoke.py`` holds the CUDA
kernels against on the card: float32 einsums per expert, with the rows at
or past each expert's count set to zero.  The backward's versions select
those rows to zero before any product (never a multiply by a mask: the
padding may hold NaN); the card's main path runs none of them.
"""
from __future__ import annotations

import torch


def live_rows(t: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[E, C, 1] bool: row c of expert e of ``t`` [E, C, *] lies below
    ``counts[e]``."""
    return (torch.arange(t.shape[1], device=t.device)[None, :, None]
            < counts.to(t.device)[:, None, None])


def _select(t: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """``t`` on the live rows, 0 elsewhere (chosen, never multiplied)."""
    return torch.where(live, t, torch.zeros((), dtype=t.dtype,
                                            device=t.device))


def group_gemm_ref(xe: torch.Tensor, w: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D] expert token slabs (rows >= counts[e] are padding),
    w: [E, D, F] -> [E, C, F] float32; padded rows produce zeros."""
    y = torch.einsum("ecd,edf->ecf", xe.float(), w.float())
    return _select(y, live_rows(xe, counts))


def group_gemm_dy_ref(dy: torch.Tensor, counts: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """dy [E, C, F] -> [E, C, F] ``dtype``: its rows below each count,
    zeros past it (what ``group_gemm_dy_cuda`` computes)."""
    return _select(dy, live_rows(dy, counts)).to(dtype)


def group_gemm_dxe_ref(dy: torch.Tensor, w: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """dy [E, C, F], w [E, D, F] -> dxe [E, C, D] float32 = dy @ w^T on
    the rows below each count, exactly 0 past it whatever dy holds
    there."""
    live = live_rows(dy, counts)
    dxe = torch.einsum("ecf,edf->ecd", _select(dy.float(), live), w.float())
    return _select(dxe, live)


def group_gemm_dw_ref(xe: torch.Tensor, dy: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """xe [E, C, D], dy [E, C, F] -> dw [E, D, F] float32 = xe^T @ dy over
    the rows below each count alone (an empty expert's dw is 0 whatever
    its rows hold)."""
    live = live_rows(xe, counts)
    return torch.einsum("ecd,ecf->edf", _select(xe.float(), live),
                        _select(dy.float(), live))
