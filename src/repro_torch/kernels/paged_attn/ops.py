"""Public paged-attention ops, from :mod:`repro.kernels.paged_attn.ops`.

Routing is by the tensors' device and nothing else: a CUDA query goes to
the hand-written kernel (:mod:`.kernel`), a CPU query to the plain
PyTorch version (:mod:`.ref`).  There is no fallback: a CUDA call the
kernel cannot take raises.

The public layout is the JAX one: q is [B, Hq, D] for decode and
[B, L, Hq, D] for prefill and verify.  The pools are read in their own
dtype; unlike the JAX ops, nothing casts the whole pool to the query dtype
on each call (eager PyTorch would copy it once per layer per step).

Sentinel handling: unallocated table entries are ``>= n_pages``.  For
reads they are clamped to a valid page here, once, and masked by the
lengths.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def _clamp_table(table: torch.Tensor, n_pages: int) -> torch.Tensor:
    return table.to(torch.int32).clamp(max=n_pages - 1).contiguous()


def _per_slot(x, b: int, device: torch.device) -> torch.Tensor:
    """A scalar or [B] vector as a contiguous int32 [B] tensor."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(b).contiguous()


def paged_attn(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, Hq, D] one-token queries; k_pages/v_pages: [N, ps, Hkv, D]
    pooled pages; table: [B, P] int32; slot b attends over the first
    ``lengths[b]`` tokens of its pages in table order.  Returns q's dtype."""
    if q.device.type == "cuda":
        return kernel.paged_attn_cuda(
            q, k_pages, v_pages, _clamp_table(table, k_pages.shape[0]),
            _per_slot(lengths, q.shape[0], q.device))
    return ref.paged_attn_ref(q, k_pages, v_pages, table,
                              lengths).to(q.dtype)


def paged_prefill_attn(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, table: torch.Tensor,
                       q_offset: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """Multi-token causal GQA queries ``q`` [B, L, Hq, D] at per-slot
    depths ``q_offset`` [B] over pooled pages, masked to each slot's
    ``kv_len``: whole-prompt prefill (``q_offset`` 0), suffix prefill
    (``q_offset`` the resident depth) and speculative verify alike."""
    if q.device.type == "cuda":
        b = q.shape[0]
        return kernel.paged_prefill_attn_cuda(
            q.contiguous(), k_pages, v_pages,
            _clamp_table(table, k_pages.shape[0]),
            _per_slot(q_offset, b, q.device), _per_slot(kv_len, b, q.device))
    return ref.paged_prefill_attn_ref(q, k_pages, v_pages, table, q_offset,
                                      kv_len)


def paged_verify_attn(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor,
                      q_offset: torch.Tensor,
                      kv_len: torch.Tensor) -> torch.Tensor:
    """Speculative-decode verify: the current token plus k drafts
    (``q`` [B, k+1, Hq, D]) at the slot's decode depth ``q_offset``.  This
    is exactly :func:`paged_prefill_attn` at Lq = k+1, under its serving
    name (see ``repro.kernels.paged_attn.ops.paged_verify_attn``)."""
    return paged_prefill_attn(q, k_pages, v_pages, table, q_offset, kv_len)
