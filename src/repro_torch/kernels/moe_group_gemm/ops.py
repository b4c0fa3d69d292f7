"""Public grouped expert GEMM op, from
:mod:`repro.kernels.moe_group_gemm.ops`: float32 out, rows at or past each
expert's count exactly zero.

Routing is by the tensors' device and nothing else: a CUDA ``xe`` goes to
the hand-written kernel (:mod:`.kernel`), a CPU ``xe`` to its plain
version (:mod:`.ref`).  There is no fallback: a CUDA call the kernel
cannot take raises.  The JAX op's ``bc`` (capacity rows per tile) is not
taken: the result does not depend on it, and the kernel picks its own
tile (:func:`.kernel.tile_rows` x :func:`.kernel.tile_cols`) and needs no
padding of C.  There is no ``interpret`` flag.

Gradients: the CUDA route is the autograd function :class:`GroupGemm`,
whose backward (:func:`group_gemm_backward`) runs hand-written kernels
and copies no weights: one pass zeroes ``dy``'s rows at or past each
count and casts it to the working dtype (the forward defines those rows
as 0 whatever the inputs, so nothing flows through them), ``dxe = dy
w^T`` reads ``w`` as it lies with the forward's skip of dead tiles, and
``dw = xe^T dy`` runs over each expert's live rows only.  ``counts`` gets
no gradient.  The CPU route is the plain version, which autograd
differentiates as it is, and which the function's backward is held to.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def group_gemm_backward(xe: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor, dy: torch.Tensor, *,
                        need_dxe: bool = True, need_dw: bool = True):
    """(dxe, dw) of the CUDA op's output given ``dy`` [E, C, F] float32,
    None where not needed, each in its input's dtype; no route copies
    ``w``.  ``dy``'s rows at or past each count are zeroed first, whatever
    they hold (NaN included), and ``xe``'s never enter ``dw``: the forward
    reads neither.  bfloat16 with C > 16 (a join's or a training step's
    slabs) runs three launches: the mask and cast of ``dy``, dxe on the
    wgmma kernel and dw over the live rows (``kernel.on_wgmma``).  float32
    and C <= 16 run the mask and cast, dxe on ``group_gemm.cu``'s tiles,
    and ``torch.bmm`` for dw over ``xe``'s rows selected to the counts, as
    JAX's autodiff computes the weight gradient outside any kernel."""
    dy_live = kernel.group_gemm_dy_cuda(dy.contiguous(), counts, xe.dtype)
    dxe = dw = None
    if need_dxe:
        dxe = kernel.group_gemm_dxe_cuda(dy_live, w, counts).to(xe.dtype)
    if need_dw:
        if kernel.on_wgmma(xe.shape[1], xe.dtype):
            dw = kernel.group_gemm_dw_cuda(xe, dy_live, counts)
        else:
            x_live = torch.where(ref.live_rows(xe, counts), xe,
                                 torch.zeros((), dtype=xe.dtype,
                                             device=xe.device))
            dw = torch.bmm(x_live.transpose(1, 2), dy_live)
    return dxe, dw


class GroupGemm(torch.autograd.Function):
    """The kernel's forward with :func:`group_gemm_backward`.  A pure
    function of its inputs, so ``torch.utils.checkpoint`` may run it
    again in a recompute."""

    @staticmethod
    def forward(ctx, xe, w, counts):
        ctx.save_for_backward(xe, w, counts)
        return kernel.group_gemm_cuda(xe, w, counts)

    @staticmethod
    def backward(ctx, dy):
        xe, w, counts = ctx.saved_tensors
        dxe, dw = group_gemm_backward(xe, w, counts, dy,
                                      need_dxe=ctx.needs_input_grad[0],
                                      need_dw=ctx.needs_input_grad[1])
        return dxe, dw, None


def group_gemm(xe: torch.Tensor, w: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D], w: [E, D, F] (one dtype), counts: [E] -> [E, C, F]
    float32, ``xe[e] @ w[e]`` on the rows below ``counts[e]`` and zero on
    the rest."""
    if xe.dim() != 3 or w.dim() != 3 or w.shape[:2] != (xe.shape[0],
                                                          xe.shape[2]):
        raise ValueError(f"xe {tuple(xe.shape)} and w {tuple(w.shape)} "
                         "must be [E, C, D] and [E, D, F]")
    if xe.device.type == "cuda":
        return GroupGemm.apply(xe.contiguous(), w.contiguous(),
                               counts.to(torch.int32).contiguous())
    return ref.group_gemm_ref(xe, w, counts)
