"""Public sparse-skinny-GEMM ops, from :mod:`repro.kernels.ss_gemm.ops`:
the host-side operand inspection (the paper's "check before issuing"),
then the kernel.

Routing is by the tensors' device and nothing else: a CUDA ``a`` goes to
the hand-written kernels (:mod:`.kernel`), a CPU ``a`` to their plain
versions (:mod:`.ref`).  There is no fallback: a CUDA call the kernels
cannot take raises.  ``bk`` keeps its JAX meaning: the k-block of B whose
emptiness is tested, the skip granularity and the unit of ``budget``.
``bm`` is accepted for the JAX signature's sake; the CUDA kernels choose
their own M tiling, and the plain versions have none.  There is no
``interpret`` flag.
"""
from __future__ import annotations

import torch

from . import kernel, ref

BM, BK = 256, 256


def block_occupancy(b: torch.Tensor, bk: int) -> torch.Tensor:
    """[ceil(K / bk)] int32 mask: 1 where the B k-block has any nonzero."""
    k = b.shape[0]
    nk = -(-k // bk)
    rows = (b != 0).any(dim=1)
    rows = torch.cat([rows, rows.new_zeros(nk * bk - k)])
    return rows.reshape(nk, bk).any(dim=1).to(torch.int32)


def _masked(a, b, mask, bk):
    if a.device.type == "cuda":
        return kernel.ssgemm_masked_cuda(a.contiguous(), b.contiguous(),
                                         mask, bk)
    return ref.ssgemm_masked_ref(a, b, mask, bk)


def ssgemm_masked(a: torch.Tensor, b: torch.Tensor, *, bm: int = BM,
                  bk: int = BK) -> torch.Tensor:
    """a [M, K] float32/bfloat16, b [K, N] in a's dtype -> [M, N] float32;
    every all-zero k-block of B is skipped."""
    bk = min(bk, a.shape[1])
    return _masked(a, b, block_occupancy(b, bk), bk)


def ssgemm_compact(a: torch.Tensor, b: torch.Tensor, *, budget: int,
                   bm: int = BM, bk: int = BK) -> torch.Tensor:
    """Compacted-index variant: the kernel walks only the live k-blocks,
    up to ``budget`` of them (in ``[1, ceil(K / bk)]``, else ValueError),
    and no other block is fetched.  Live blocks past the budget are added
    by a plain product of A with those blocks of B, as the JAX op does, so
    the result stays exact.  That guard costs one host read per call (the
    live count), taken after the kernel is queued."""
    bk = min(bk, a.shape[1])
    occ = block_occupancy(b, bk)
    nk = occ.shape[0]
    if not isinstance(budget, int) or not 1 <= budget <= nk:
        raise ValueError(f"budget must be an int in [1, {nk}] (the k-blocks "
                         f"of K={a.shape[1]} in blocks of {bk}), got "
                         f"{budget!r}")
    order = torch.argsort(-occ, stable=True)   # live blocks first, in order
    n_live = occ.sum()
    capped = torch.clamp(n_live, max=budget)
    idx = torch.where(torch.arange(budget, device=occ.device) < capped,
                      order[:budget],
                      order[(capped - 1).clamp_min(0)]).to(torch.int32)
    capped = capped.reshape(1).to(torch.int32)
    if a.device.type == "cuda":
        out = kernel.ssgemm_compact_cuda(a.contiguous(), b.contiguous(),
                                         idx, capped, bk)
    else:
        out = ref.ssgemm_compact_ref(a, b, idx, capped, bk)
    over = int(n_live) - budget
    if over > 0:                     # exactness guard
        out = out + ref.ssgemm_compact_ref(a, b, order[budget:], over, bk)
    return out


def ssgemm(a: torch.Tensor, b: torch.Tensor, *,
           sparsity_aware: bool = True) -> torch.Tensor:
    """Default entry point: the masked skip when sparsity-aware, else the
    same kernel over every k-block (dense)."""
    if sparsity_aware:
        return ssgemm_masked(a, b)
    bk = min(BK, a.shape[1])
    ones = torch.ones(-(-a.shape[1] // bk), dtype=torch.int32,
                      device=a.device)
    return _masked(a, b, ones, bk)
