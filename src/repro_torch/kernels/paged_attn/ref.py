"""Plain PyTorch versions of the paged-attention kernels, from
:mod:`repro.kernels.paged_attn.ref` (and ``decode_attn/ref.py``).

These are what the ops run on CPU tensors and what ``chip_smoke.py``
holds the CUDA kernels against on the card: the same gathers, the same
``-1e30`` masking and the same float32 softmax as the JAX references.
"""
from __future__ import annotations

import math

import torch


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool: [N, ps, ...]; table: [B, P] int32 page ids (entries >= N
    clamp to the last page; callers mask by length).  Returns the
    contiguous view [B, P * ps, ...]."""
    n, ps = pool.shape[:2]
    gathered = pool[table.long().clamp(max=n - 1)]      # [B, P, ps, ...]
    return gathered.reshape((table.shape[0], table.shape[1] * ps)
                            + tuple(pool.shape[2:]))


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    length: torch.Tensor) -> torch.Tensor:
    """q: [B, Hq, D]; k/v: [B, S, Hkv, D]; slot b attends over
    k[b, :length[b]].  Returns float32 [B, Hq, D]."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k.float()) / math.sqrt(d * 1.0)
    ln = torch.as_tensor(length, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b)
    mask = (torch.arange(s, device=q.device)[None, None, None, :]
            < ln[:, None, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return out.reshape(b, hq, d)


def paged_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, table: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, Hq, D]; k_pages/v_pages: [N, ps, Hkv, D]; table: [B, P];
    lengths: [B] int32.  Slot b attends over its first lengths[b] tokens in
    page-table order.  Returns float32 [B, Hq, D]."""
    k = gather_pages(k_pages, table)
    v = gather_pages(v_pages, table)
    return decode_attn_ref(q, k, v, lengths)


def paged_prefill_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           q_offset: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """Multi-token causal GQA attention through a page table: q [B, L, Hq,
    D] sit at per-slot depths ``q_offset`` [B]; slot b's query at position
    ``q_offset[b] + t`` attends over its first
    ``min(q_offset[b] + t + 1, kv_len[b])`` gathered tokens.  Returns
    [B, L, Hq, D] in q's dtype, with the softmax weights cast back to that
    dtype before the value product, as the JAX reference does."""
    b, lq, hq, d = q.shape
    k = gather_pages(k_pages, table).to(q.dtype)
    v = gather_pages(v_pages, table).to(q.dtype)
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, lq, hkv, g, d)
    lk = k.shape[1]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(d)
    scores = scores.float()
    dev = q.device
    off = torch.as_tensor(q_offset, dtype=torch.int32,
                          device=dev).reshape(-1).expand(b)
    kvl = torch.as_tensor(kv_len, dtype=torch.int32,
                          device=dev).reshape(-1).expand(b)
    kpos = torch.arange(lk, device=dev)
    qpos = off[:, None, None] + torch.arange(lq, device=dev)[:, None]
    mask = ((kpos[None, None, :] <= qpos)
            & (kpos[None, None, :] < kvl[:, None, None]))    # [B, Lq, Lk]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, lq, hq, v.shape[-1])
