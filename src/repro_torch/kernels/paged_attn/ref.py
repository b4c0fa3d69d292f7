"""Plain PyTorch versions of the paged-attention kernels, from
:mod:`repro.kernels.paged_attn.ref` (and ``decode_attn/ref.py``).

These are what the ops run on CPU tensors and what ``chip_smoke.py``
holds the CUDA kernels against on the card: the same gathers, the same
``-1e30`` masking and the same float32 softmax as the JAX references, but
with the TPU kernels' answer where a query sees no key (a slot of length
0): zeros, from ``acc / max(l, 1e-30)`` over no live key, not the uniform
average of every masked row that a softmax of all -1e30 scores gives.

:func:`decode_split_ref` computes the decode kernels' split-KV schedule
(:mod:`.split`) step by step, for the tests; no op runs it.
"""
from __future__ import annotations

import math

import torch

from . import split


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
    k[b, :length[b]], and a slot of length 0 gives zeros, as the TPU
    kernel ``paged_attn_kernel`` does (not JAX's ``paged_attn_xla``, whose
    softmax averages the masked rows there).  Returns float32 [B, Hq, D]."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k.float()) / math.sqrt(d * 1.0)
    ln = torch.as_tensor(length, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b)
    live = (torch.arange(s, device=q.device)[None, None, None, :]
            < ln[:, None, None, None])
    scores = torch.where(live, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(b, hq, d)


def paged_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, table: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, Hq, D]; k_pages/v_pages: [N, ps, Hkv, D]; table: [B, P];
    lengths: [B] int32.  Slot b attends over its first lengths[b] tokens in
    page-table order; a slot of length 0 gives zeros, as the TPU kernel
    ``paged_attn_kernel`` does.  Returns float32 [B, Hq, D]."""
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
    ``min(q_offset[b] + t + 1, kv_len[b])`` gathered tokens; a row that
    sees no key (``kv_len`` 0) gives zeros, as the TPU kernel
    ``paged_prefill_attn_kernel`` does.  Returns [B, L, Hq, D] in q's
    dtype, with the softmax weights cast back to that dtype before the
    value product, as the JAX reference does."""
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
    live = mask[:, None, None]
    scores = torch.where(live, scores, torch.full_like(scores, -1e30))
    p = torch.where(live, torch.exp(scores - scores.amax(-1, keepdim=True)),
                    torch.zeros_like(scores))
    w = (p / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, lq, hq, v.shape[-1])


def decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, splits: int) -> torch.Tensor:
    """The decode kernels' split-KV schedule, step by step (tests only).
    q: [B, Hq, D]; k/v: [B, S, Hkv, D]; slot b attends over its first
    ``n = min(length[b], S)`` rows.  Rank r of ``splits`` keeps the float32
    state (m, l, acc) of its keys ``split.split_range(r, splits, n)``; an
    empty range keeps (-1e30, 0, 0).  The ranks merge as a cluster does:
    M = max m_r, L = sum l_r exp(m_r - M), and the output is
    sum acc_r exp(m_r - M) / max(L, 1e-30).  Returns float32 [B, Hq, D]."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg,
                          k.float()) / math.sqrt(d * 1.0)
    ln = torch.as_tensor(length, dtype=torch.int64).reshape(-1).expand(b)
    out = torch.empty(b, hkv, g, d, device=q.device)
    for i in range(b):
        n = min(int(ln[i]), s)
        ms, ls, accs = [], [], []
        for r in range(splits):
            lo, hi = split.split_range(r, splits, n)
            sc = scores[i, :, :, lo:hi]                     # [Hkv, G, hi-lo]
            m = (sc.amax(-1, keepdim=True) if hi > lo else
                 torch.full((hkv, g, 1), -1e30, device=q.device))
            p = torch.exp(sc - m)
            ms.append(m)
            ls.append(p.sum(-1, keepdim=True))
            accs.append(torch.einsum("hgs,shd->hgd", p, v[i, lo:hi].float()))
        m = torch.stack(ms)
        w = torch.exp(m - m.amax(0))
        l_sum = (torch.stack(ls) * w).sum(0)
        out[i] = (torch.stack(accs) * w).sum(0) / l_sum.clamp_min(1e-30)
    return out.reshape(b, hq, d)

