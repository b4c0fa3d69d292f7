"""GQA attention over a paged KV cache, from :mod:`repro.models.attention`.

Queries are reshaped to [B, L, Hkv, G, D] and contracted against the
unexpanded KV heads; repeated KV heads are never materialised.

Paged layout: K/V pages live in one pooled allocation per layer shared by
every slot, and ``table`` names each slot's pages in order.  The pool
holds ``n_pages + 1`` pages: ids ``0 .. n_pages - 1`` are the live pages
the allocator hands out, and the last one is a **sink**.  The allocator's
sentinel id is ``n_pages`` (see :class:`repro_torch.serve.kvpool.KVPool`),
so a write through an unallocated entry, or past the table's width, is
redirected to the sink where JAX drops it with ``mode="drop"``; PyTorch has
no drop mode, and a masked write with a data-dependent shape would cost a
host sync per call.  No read of live data ever comes from the sink.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..kernels.paged_attn import paged_attn, paged_prefill_attn
from .layers import dense, rope_tables, rotate


class PagedKVCache(NamedTuple):
    k: torch.Tensor           # [n_pages + 1, page_size, Hkv, D] (+1: sink)
    v: torch.Tensor           # [n_pages + 1, page_size, Hkv, D]
    table: torch.Tensor       # [B, P] int32 page ids
    length: torch.Tensor      # [B] int32: tokens filled per slot


def attention_core(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Causal attention of the cache-free forward: q [B,L,Hq,D], k/v
    [B,L,Hkv,D] -> [B,L,Hq,D], softmax in float32.  The port keeps only
    the dense core; the JAX module's blockwise core for very long
    cache-free sequences is not on the serving path."""
    b, l, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, l, hkv, hq // hkv, d)
    scores = (torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(d)).float()
    causal = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, l, hq, v.shape[-1])


def paged_write_index(table: torch.Tensor, length: torch.Tensor,
                      n_tokens: int, n_live: int,
                      page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat (page, offset) write address of each of the ``n_tokens`` new
    tokens of every row: row b's token at sequence position
    ``length[b] + t`` goes to page ``table[b, (length[b] + t) // ps]`` at
    offset ``% ps``.  Positions whose logical page is past the table's
    width, or whose entry is not a live page (a sentinel id >= n_live), are
    masked out: their address is the sink page ``n_live``.  Every layer of
    a forward writes at the same addresses, so the forward computes them
    once."""
    dev = table.device
    p_max = table.shape[1]
    pos = (length.to(torch.int64)[:, None]
           + torch.arange(n_tokens, device=dev, dtype=torch.int64)[None, :])
    logical = pos // page_size                                # [B, L]
    page = torch.gather(table.to(torch.int64), 1,
                        logical.clamp(max=p_max - 1))
    live = (logical < p_max) & (page >= 0) & (page < n_live)
    page = torch.where(live, page, torch.full_like(page, n_live))
    return page.reshape(-1), (pos % page_size).reshape(-1)


def _paged_insert(pool: torch.Tensor, vals: torch.Tensor,
                  table: torch.Tensor, length: torch.Tensor,
                  index: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """Write ``vals`` [B, L, ...] into the page pool [n_pages + 1, ps, ...]
    in place, at the addresses of :func:`paged_write_index` (``index``,
    when the caller has computed them).  A join's non-joining rows carry
    all-sentinel tables, so their writes reach the sink and never another
    slot's pages.  The address depends on the position only, so the insert
    is rollback-safe for speculative verify, as in JAX."""
    if index is None:
        index = paged_write_index(table, length, vals.shape[1],
                                  pool.shape[0] - 1, pool.shape[1])
    page, offset = index
    b, l = vals.shape[:2]
    pool[page, offset] = vals.reshape((b * l,) + tuple(vals.shape[2:])
                                      ).to(pool.dtype)
    return pool


def gqa_apply(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor | None = None,
              rope: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache: PagedKVCache | None = None, write_index=None):
    """x: [B, L, D].  With a paged ``cache``, writes this call's K/V at
    ``cache.length`` through the table, then attends over the filled
    prefix: a one-token call (decode) through :func:`paged_attn`, anything
    longer (prefill, suffix prefill, verify) through
    :func:`paged_prefill_attn`.  ``rope`` is the (cos, sin) pair of
    ``positions`` and ``write_index`` the cache write addresses, when the
    caller has computed them once for all layers."""
    if rope is None:
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = rotate(dense(params["q"], x), *rope)
    k = rotate(dense(params["k"], x), *rope)
    v = dense(params["v"], x)
    new_cache = None
    if cache is not None:
        # the insert precedes the read, in stream order: rows of one call
        # that share pages see each other's writes
        if write_index is None:
            write_index = paged_write_index(
                cache.table, cache.length, x.shape[1], cache.k.shape[0] - 1,
                cache.k.shape[1])
        kp = _paged_insert(cache.k, k, cache.table, cache.length, write_index)
        vp = _paged_insert(cache.v, v, cache.table, cache.length, write_index)
        kv_len = cache.length + x.shape[1]
        new_cache = PagedKVCache(kp, vp, cache.table, kv_len)
        if x.shape[1] == 1:
            out = paged_attn(q[:, 0], kp, vp, cache.table, kv_len)[:, None]
        else:
            out = paged_prefill_attn(q, kp, vp, cache.table, cache.length,
                                     kv_len)
    else:
        out = attention_core(q, k, v)
    y = dense(params["o"], out, n_in=2)
    return y, new_cache
