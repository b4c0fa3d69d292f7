"""Plain PyTorch versions of the skinny GEMM, from
:mod:`repro.kernels.ss_gemm.ref`: the op oracle, and one plain version per
CUDA kernel on the kernel's own arguments.  They are the CPU path of
:mod:`.ops` and what the kernels are held against on the card.

Each computes in float32, or in float64 when ``a`` is float64 (a check
with a worst-case rounding bound evaluates them on float64 copies of the
kernel's inputs).  The kernel versions gather the walked columns, so a
skipped block is not read here either.
"""
from __future__ import annotations

import torch


def ssgemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [M, K] dense, b: [K, N] skinny (sparse) -> [M, N] in float32."""
    return torch.matmul(a.float(), b.float())


def _compute_dtype(a: torch.Tensor) -> torch.dtype:
    return torch.float64 if a.dtype == torch.float64 else torch.float32


def _blocks_product(a: torch.Tensor, b: torch.Tensor, blocks: torch.Tensor,
                    bk: int) -> torch.Tensor:
    """Sum over the listed k-blocks (repeats count again) of
    a[:, blk] @ b[blk], the last block cut at K."""
    k = a.shape[1]
    cols = (blocks.long()[:, None] * bk
            + torch.arange(bk, device=a.device)[None, :]).reshape(-1)
    cols = cols[cols < k]
    ct = _compute_dtype(a)
    return torch.matmul(a.index_select(1, cols).to(ct),
                        b.index_select(0, cols).to(ct))


def ssgemm_masked_ref(a: torch.Tensor, b: torch.Tensor,
                      block_mask: torch.Tensor, bk: int) -> torch.Tensor:
    """The sum of A @ B over the k-blocks of ``bk`` rows whose
    ``block_mask`` entry is set ([ceil(K / bk)] int32)."""
    live = torch.nonzero(block_mask.reshape(-1)).reshape(-1)
    return _blocks_product(a, b, live, bk)


def ssgemm_compact_ref(a: torch.Tensor, b: torch.Tensor,
                       block_idx: torch.Tensor, n_live, bk: int
                       ) -> torch.Tensor:
    """The sum of A @ B over the first ``n_live`` k-blocks listed in
    ``block_idx`` ([budget] int32; ``n_live`` an int or a [1] tensor,
    capped at the budget)."""
    n = min(max(int(torch.as_tensor(n_live).reshape(-1)[0]), 0),
            block_idx.shape[0])
    return _blocks_product(a, b, block_idx[:n], bk)
