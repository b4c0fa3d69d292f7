"""GQA attention over a KV cache, from :mod:`repro.models.attention`.

Queries are reshaped to [B, L, Hkv, G, D] and contracted against the
unexpanded KV heads; repeated KV heads are never materialised.

Dense-stripe layout (:class:`KVCache`): each slot owns a contiguous stripe
``[B, max_len + 1, Hkv, D]`` per layer.  Row ``max_len`` is a **sink**: JAX
scatters with ``mode="drop"``, so a slot at ``max_len`` that still writes
its (discarded) token each step loses that write; PyTorch has no drop
mode, and an index out of range is a device-side assert on CUDA, so the
port sends every write at or past ``max_len`` to the sink row.  No read
reaches it: every attention call is bounded to the first ``max_len`` rows.

Paged layout (:class:`PagedKVCache`): K/V pages live in one pooled
allocation per layer shared by every slot, and ``table`` names each slot's
pages in order.  The pool holds ``n_pages + 1`` pages: ids
``0 .. n_pages - 1`` are the live pages the allocator hands out, and the
last one is the sink.  The allocator's sentinel id is ``n_pages`` (see
:class:`repro_torch.serve.kvpool.KVPool`), so a write through an
unallocated entry, or past the table's width, is redirected to the sink
where JAX drops it.  No read of live data ever comes from the sink.

A masked write with a data-dependent shape would cost a host sync per
call; the sinks keep every write's shape fixed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..kernels.decode_attn import decode_attn
from ..kernels.paged_attn import paged_attn, paged_prefill_attn
from .layers import dense, rope_tables, rotate


class KVCache(NamedTuple):
    k: torch.Tensor           # [B, max_len + 1, Hkv, D] (+1: sink row)
    v: torch.Tensor           # [B, max_len + 1, Hkv, D]
    length: torch.Tensor | int   # [B] int32 per slot, or one offset


class PagedKVCache(NamedTuple):
    k: torch.Tensor           # [n_pages + 1, page_size, Hkv, D] (+1: sink)
    v: torch.Tensor           # [n_pages + 1, page_size, Hkv, D]
    table: torch.Tensor       # [B, P] int32 page ids
    length: torch.Tensor      # [B] int32: tokens filled per slot


def _dense_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset=0, kv_len=None) -> torch.Tensor:
    """q: [B, Lq, Hkv, G, D], k/v: [B, Lk, Hkv, D] -> [B, Lq, Hkv, G, D].
    ``q_offset`` and ``kv_len`` are ints or per-slot [B] tensors: row b's
    query t sits at position ``q_offset[b] + t`` and sees keys up to it
    (``causal``) and below ``kv_len[b]``.  Softmax in float32, masked
    scores at -1e30, as in JAX."""
    b, lq, _, _, d = q.shape
    lk = k.shape[1]
    dev = q.device
    scores = (torch.einsum("bqhgd,bkhd->bhgqk", q, k) / math.sqrt(d)).float()
    kpos = torch.arange(lk, device=dev)
    off = torch.as_tensor(q_offset, device=dev).reshape(-1, 1, 1)   # [B|1]
    qpos = off + torch.arange(lq, device=dev)[None, :, None]        # [.,Lq,1]
    mask = torch.ones((1, lq, lk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos)
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=dev).reshape(-1, 1, 1)
        mask = mask & (kpos[None, None, :] < kvl)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", w, v)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, q_offset=0,
                   kv_len=None) -> torch.Tensor:
    """q [B,Lq,Hq,D], k/v [B,Lk,Hkv,D] -> [B,Lq,Hq,D], through
    :func:`_dense_attn`.  The port keeps only the dense core; the JAX
    module's blockwise core for very long cache-free sequences is not on
    the serving path."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    out = _dense_attn(q.reshape(b, lq, hkv, hq // hkv, d), k, v,
                      causal=causal, q_offset=q_offset, kv_len=kv_len)
    return out.reshape(b, lq, hq, v.shape[-1])


def dense_write_index(length: torch.Tensor, n_tokens: int,
                      max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot, row) write address of each of the ``n_tokens`` new tokens of
    every slot, for per-slot ``length`` [B]: row ``length[b] + t``, or the
    sink row ``max_len`` where that is at or past ``max_len`` (JAX drops
    those writes).  Every layer of a forward writes at the same addresses,
    so the forward computes them once."""
    dev = length.device
    pos = (length.to(torch.int64)[:, None]
           + torch.arange(n_tokens, device=dev, dtype=torch.int64)[None, :])
    pos = torch.where(pos < max_len, pos, torch.full_like(pos, max_len))
    slot = torch.arange(length.shape[0], device=dev)[:, None].expand_as(pos)
    return slot, pos


def _cache_insert(buf: torch.Tensor, vals: torch.Tensor, length,
                  index: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """Write ``vals`` [B, L, ...] into the stripe ``buf`` [B, max_len + 1,
    ...] in place, from ``length``.  An int offset is one shared slice,
    clamped as ``jax.lax.dynamic_update_slice`` clamps its start (into
    ``[0, max_len - L]``); per-slot lengths ([B]) scatter each slot at its
    own depth, at the addresses of :func:`dense_write_index` (``index``,
    when the caller has computed them), so writes JAX would drop land in
    the sink row."""
    max_len = buf.shape[1] - 1
    vals = vals.to(buf.dtype)
    if not isinstance(length, torch.Tensor) or length.dim() == 0:
        n = vals.shape[1]
        if n > max_len:
            raise ValueError(f"{n} rows do not fit a stripe of {max_len}")
        start = min(max(int(length), 0), max_len - n)
        buf[:, start:start + n] = vals
        return buf
    if index is None:
        index = dense_write_index(length, vals.shape[1], max_len)
    buf[index] = vals
    return buf


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
              cache: KVCache | PagedKVCache | None = None,
              write_index=None, kv_cap: int | None = None):
    """x: [B, L, D].  With a ``cache``, writes this call's K/V at
    ``cache.length`` and attends over the filled prefix.

    Dense stripes: a one-token call (decode) goes through
    :func:`decode_attn`, which reads at most the first ``kv_cap`` rows
    (a host-known bound on the deepest live slot; the whole stripe when
    None); a longer call (prefill) through :func:`attention_core` over the
    stripe, or over its first ``length + L`` rows for an int offset, since
    the masked keys past them contribute exactly zero.  Paged: a one-token
    call through :func:`paged_attn`, anything longer (prefill, suffix
    prefill, verify) through :func:`paged_prefill_attn`.

    ``rope`` is the (cos, sin) pair of ``positions`` and ``write_index``
    the cache write addresses, when the caller has computed them once for
    all layers."""
    if rope is None:
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = rotate(dense(params["q"], x), *rope)
    k = rotate(dense(params["k"], x), *rope)
    v = dense(params["v"], x)
    n = x.shape[1]
    new_cache = None
    # the insert precedes the read, in stream order: rows of one call see
    # each other's writes
    if isinstance(cache, PagedKVCache):
        if write_index is None:
            write_index = paged_write_index(
                cache.table, cache.length, n, cache.k.shape[0] - 1,
                cache.k.shape[1])
        kp = _paged_insert(cache.k, k, cache.table, cache.length, write_index)
        vp = _paged_insert(cache.v, v, cache.table, cache.length, write_index)
        kv_len = cache.length + n
        new_cache = PagedKVCache(kp, vp, cache.table, kv_len)
        if n == 1:
            out = paged_attn(q[:, 0], kp, vp, cache.table, kv_len)[:, None]
        else:
            out = paged_prefill_attn(q, kp, vp, cache.table, cache.length,
                                     kv_len)
    elif cache is not None:
        kc = _cache_insert(cache.k, k, cache.length, write_index)
        vc = _cache_insert(cache.v, v, cache.length, write_index)
        kv_len = cache.length + n
        new_cache = KVCache(kc, vc, kv_len)
        cap = kc.shape[1] - 1                  # the sink row is never read
        if kv_cap is not None:
            cap = min(cap, kv_cap)
        if n == 1:
            out = decode_attn(q[:, 0], kc, vc, kv_len, s_cap=cap)[:, None]
        else:
            if not isinstance(kv_len, torch.Tensor) or kv_len.dim() == 0:
                cap = min(cap, int(kv_len))
            out = attention_core(q, kc[:, :cap], vc[:, :cap],
                                 q_offset=cache.length, kv_len=kv_len)
    else:
        out = attention_core(q, k, v)
    y = dense(params["o"], out, n_in=2)
    return y, new_cache
