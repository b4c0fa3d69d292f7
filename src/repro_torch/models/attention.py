"""GQA and multi-head latent attention (MLA) over a KV cache, from
:mod:`repro.models.attention`.

Queries are reshaped to [B, L, Hkv, G, D] and contracted against the
unexpanded KV heads; repeated KV heads are never materialised.  The
softmax core is dense, or blockwise (an online softmax over query and key
blocks, :func:`_blockwise_attn`) for a cache-free call whose score matrix
would pass ``_DENSE_LIMIT`` elements a head, as in JAX.

MLA (deepseek-v3) caches the compressed latent ``c_kv`` and one shared
RoPE key per token, with no head axis: stripes ``[B, max_len + 1, r]``
and ``[B, max_len + 1, rope]``, pools ``[n_pages + 2, page_size, r]`` and
``[.., rope]``, with the same sink row and sentinel and sink pages as
below.  Its queries are absorbed into the latent (JAX's absorbed path),
and it attends through :func:`gather_pages` and :func:`attention_core`
on every cache kind: no hand-written kernel, as JAX keeps it on the XLA
gather (its 128 query heads over one latent key of width 576 fit no
kernel's group or head dim).

Dense-stripe layout (:class:`KVCache`): each slot owns a contiguous stripe
``[B, max_len + 1, Hkv, D]`` per layer.  Row ``max_len`` is a **sink**: JAX
scatters with ``mode="drop"``, so a slot at ``max_len`` that still writes
its (discarded) token each step loses that write; PyTorch has no drop
mode, and an index out of range is a device-side assert on CUDA, so the
port sends every write at or past ``max_len`` to the sink row.  No read
reaches it: every attention call is bounded to the first ``max_len`` rows.

Paged layout (:class:`PagedKVCache`): K/V pages live in one pooled
allocation per layer shared by every slot, and ``table`` names each slot's
pages in order.  The pool holds ``n_pages + 2`` pages: ids
``0 .. n_pages - 1`` are the live pages the allocator hands out.  Page
``n_pages`` is the allocator's sentinel id (see
:class:`repro_torch.serve.kvpool.KVPool`) and no write ever reaches it, so
a read through an unallocated entry sees zeros, as JAX's read of a
never-written page does.  Page ``n_pages + 1`` is the sink: a write
through an unallocated entry, or past the table's width, goes there where
JAX drops it.  Many rows write the sink at once, so its content differs
from run to run on the card; no read reaches it.  (Reads of unallocated
entries do happen: a join's padding positions and a retired slot's decode
read them, and in a MoE model those rows take expert capacity from the
live ones, so what they read must not vary.)

A masked write with a data-dependent shape would cost a host sync per
call; the sinks keep every write's shape fixed.

Routing: every attention op called here reads the active
:class:`~repro_torch.kernels.decode_attn.ops.DecodeAttnPolicy` (the
serving engine enters the batcher's around every join and decode loop),
as JAX's layer does at trace time: in mode ``"auto"`` the hand-written
kernels on the card and their plain versions on the CPU, in ``"plain"``
the gather-then-attend and plain PyTorch versions on either device, in
``"kernel"`` the kernels (a CPU tensor raises).  The paged ops also take
their tuned launch from the policy.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..configs.base import ArchConfig, AttnKind
from ..kernels.decode_attn import decode_attn
from ..kernels.paged_attn import (gather_pages, paged_attn,
                                  paged_prefill_attn, paged_verify_attn)
from ..distributed.act_sharding import (batch_sharded, coordinate,
                                        constrain,
                                        constrain_btd, context_shard_wanted,
                                        from_local, is_sharded, local_region,
                                        to_local)
from ..parthook import part
from .layers import dense, rmsnorm, rope_tables, rotate

BLOCK_Q = 512
BLOCK_K = 1024
_DENSE_LIMIT = 4096 * 4096   # score elements a head past which a cache-free
                             # call goes blockwise


class KVCache(NamedTuple):
    k: torch.Tensor           # [B, max_len + 1, Hkv, D] (+1: sink row);
    v: torch.Tensor           # MLA: latent [.., r] and rope key [.., rope]
    length: torch.Tensor | int   # [B] int32 per slot, or one offset


class PagedKVCache(NamedTuple):
    k: torch.Tensor           # [n_pages + 2, page_size, Hkv, D]: + zero
    v: torch.Tensor           # page (the sentinel's) and the sink; MLA:
                              # latent [.., r] and rope key [.., rope]
    table: torch.Tensor       # [B, P] int32 page ids
    length: torch.Tensor      # [B] int32: tokens filled per slot


def _dense_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset=0, kv_len=None) -> torch.Tensor:
    """q: [B, Lq, Hkv, G, D], k: [B, Lk, Hkv, D], v: [B, Lk, Hkv, Dv] ->
    [B, Lq, Hkv, G, Dv].  ``q_offset`` and ``kv_len`` are ints or
    per-slot [B] tensors: row b's query t sits at position ``q_offset[b] +
    t`` and sees keys up to it (``causal``) and below ``kv_len[b]``.
    Softmax in float32, masked scores at -1e30, as in JAX."""
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


def _blockwise_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Flash-style online-softmax attention, O(block) memory: q [B, Lq,
    Hkv, G, D], k [B, Lk, Hkv, D], v [B, Lk, Hkv, Dv] -> [B, Lq, Hkv, G,
    Dv].  Queries and keys are padded to whole ``BLOCK_Q`` / ``BLOCK_K``
    blocks, keys at or past Lk (and, ``causal``, past each query's
    position ``q_offset + t``) are masked at -1e30, and the running max,
    sum and output stay in float32, as JAX's nested scan does."""
    b, lq, hkv, g, d = q.shape
    lk, dv = k.shape[1], v.shape[-1]
    bq, bk = min(BLOCK_Q, lq), min(BLOCK_K, lk)
    nq, nk = -(-lq // bq), -(-lk // bk)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, nq * bq - lq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * bk - lk))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * bk - lk))
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    out = q.new_empty((b, nq * bq, hkv, g, dv))
    for qi in range(nq):
        qblk = q[:, qi * bq:(qi + 1) * bq]
        qpos = (qi * bq + torch.arange(bq, device=dev)[:, None]
                + q_offset)
        m = torch.full((b, hkv, g, bq), -math.inf, device=dev)
        l = torch.zeros((b, hkv, g, bq), device=dev)
        acc = torch.zeros((b, hkv, g, bq, dv), device=dev)
        for ki in range(nk):
            kblk = k[:, ki * bk:(ki + 1) * bk]
            vblk = v[:, ki * bk:(ki + 1) * bk]
            s = (torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk)
                 * scale).float()
            kpos = ki * bk + torch.arange(bk, device=dev)[None, :]
            mask = kpos < lk
            if causal:
                mask = mask & (kpos <= qpos)
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(q.dtype), vblk)
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]          # [B,Hkv,G,bq,Dv]
        out[:, qi * bq:(qi + 1) * bq] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out[:, :lq]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, q_offset=0,
                   kv_len=None) -> torch.Tensor:
    """q [B,Lq,Hq,D], k [B,Lk,Hkv,D], v [B,Lk,Hkv,Dv] -> [B,Lq,Hq,Dv] (Dv
    may differ from D, as MLA's latent values do).  A cache-free call
    (``kv_len`` None) whose Lq x Lk passes ``_DENSE_LIMIT`` goes through
    :func:`_blockwise_attn`, every other through :func:`_dense_attn`, as
    JAX's switch does."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, lq, hkv, hq // hkv, d)
    if kv_len is None and lq * k.shape[1] > _DENSE_LIMIT:
        out = _blockwise_attn(qg, k, v, causal=causal, q_offset=q_offset)
    else:
        out = _dense_attn(qg, k, v, causal=causal, q_offset=q_offset,
                          kv_len=kv_len)
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
    masked out: their address is the sink page ``n_live + 1``, so the
    sentinel's own page ``n_live`` is never written.  Every layer of a
    forward writes at the same addresses, so the forward computes them
    once."""
    dev = table.device
    p_max = table.shape[1]
    pos = (length.to(torch.int64)[:, None]
           + torch.arange(n_tokens, device=dev, dtype=torch.int64)[None, :])
    logical = pos // page_size                                # [B, L]
    page = torch.gather(table.to(torch.int64), 1,
                        logical.clamp(max=p_max - 1))
    live = (logical < p_max) & (page >= 0) & (page < n_live)
    page = torch.where(live, page, torch.full_like(page, n_live + 1))
    return page.reshape(-1), (pos % page_size).reshape(-1)


def _paged_insert(pool: torch.Tensor, vals: torch.Tensor,
                  table: torch.Tensor, length: torch.Tensor,
                  index: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """Write ``vals`` [B, L, ...] into the page pool [n_pages + 2, ps, ...]
    in place, at the addresses of :func:`paged_write_index` (``index``,
    when the caller has computed them).  A join's non-joining rows carry
    all-sentinel tables, so their writes reach the sink and never another
    slot's pages.  The address depends on the position only, so the insert
    is rollback-safe for speculative verify, as in JAX."""
    if index is None:
        index = paged_write_index(table, length, vals.shape[1],
                                  pool.shape[0] - 2, pool.shape[1])
    page, offset = index
    b, l = vals.shape[:2]
    pool[page, offset] = vals.reshape((b * l,) + tuple(vals.shape[2:])
                                      ).to(pool.dtype)
    return pool


def gqa_apply(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor | None = None,
              rope: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache: KVCache | PagedKVCache | None = None,
              write_index=None, kv_cap: int | None = None,
              verify: bool = False, causal: bool = True,
              kv_override: tuple[torch.Tensor, torch.Tensor] | None = None):
    """x: [B, L, D].  With a ``cache``, writes this call's K/V at
    ``cache.length`` and attends over the filled prefix.

    ``kv_override`` (k, v), each [B, Lk, Hkv, D], makes this layer
    cross-attention, as in JAX: the query is projected and not rotated,
    k and v are taken as given, no cache is read or written, and the call
    goes through :func:`attention_core` with ``causal`` (False from the
    cross branch).  Without a cache, ``causal`` is the self-attention's
    mask: the encoder's is off.

    Dense stripes: a one-token call (decode) goes through
    :func:`decode_attn`, which reads at most the first ``kv_cap`` rows
    (a host-known bound on the deepest live slot; the whole stripe when
    None); a longer call (prefill) through :func:`attention_core` over the
    stripe, or over its first ``length + L`` rows for an int offset, since
    the masked keys past them contribute exactly zero.  Paged: a one-token
    call through :func:`paged_attn`, anything longer (prefill, suffix
    prefill) through :func:`paged_prefill_attn`, and a speculative verify
    (``verify``, from ``Model.decode_step`` at L = k+1) through
    :func:`paged_verify_attn`, the same kernel under its own tuned launch.
    Each op routes by the active policy.

    ``rope`` is the (cos, sin) pair of ``positions`` and ``write_index``
    the cache write addresses, when the caller has computed them once for
    all layers."""
    ctx_shard = is_sharded(x) and context_shard_wanted(cfg.n_heads,
                                                       x.shape[1])
    if ctx_shard:
        # context parallelism: q path seq-sharded; kv replicated (gathered)
        x = constrain(x, ("batch", "ctx", None))
    q = dense(params["q"], x)
    if kv_override is None:
        if rope is None:
            rope = rope_tables(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = rotate(q, *rope)
        k = rotate(dense(params["k"], x), *rope)
        v = dense(params["v"], x)
    else:
        k, v = kv_override
        cache = None
    if is_sharded(x):
        if ctx_shard:
            q = constrain(q, ("batch", "ctx", None, None))
            k = constrain(k, ("batch", None, None, None))
            v = constrain(v, ("batch", None, None, None))
        if isinstance(cache, PagedKVCache):
            raise NotImplementedError("the sharded path serves dense "
                                      "stripes, as JAX's decode step")
        out = _gqa_core_sharded(q, k, v, cache, kv_cap=kv_cap,
                                causal=causal)
        new_cache = None if cache is None else KVCache(
            cache.k, cache.v, cache.length + x.shape[1])
    else:
        out, new_cache = _gqa_core(q, k, v, cache, write_index=write_index,
                                   kv_cap=kv_cap, verify=verify,
                                   causal=causal)
    y = dense(params["o"], out, n_in=2)
    if ctx_shard:
        y = constrain_btd(y)
    return y, new_cache


def _gqa_core_sharded(q, k, v, cache, *, kv_cap, causal):
    """The attention core of :func:`gqa_apply` on DTensors: q/k/v (and a
    cache) on local tensors.  Without a cache, heads sharded alike on
    ``model`` attend locally (head parallelism), and a sequence-sharded
    q (context parallelism) attends over the gathered keys at its
    global offset; anything else runs on the batch shard, replicated over
    ``model``, through :func:`_gqa_core` and its kernels."""
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    qm = q.placements[mi] if mi is not None else None
    if cache is None and qm == Shard(2) and k.placements[mi] == Shard(2) \
            and v.placements[mi] == Shard(2):
        keep = batch_sharded(q) + ("model",)
        ql, pl = to_local(q, keep=keep)
        kl, _ = to_local(k, keep=keep)
        vl, _ = to_local(v, keep=keep)
        return from_local(attention_core(ql, kl, vl, causal=causal),
                          mesh, pl)
    if cache is None and qm == Shard(1):
        keep = batch_sharded(q)
        ql, pl = to_local(q, keep=keep + ("model",))
        kl, _ = to_local(k, keep=keep, partial=("model",))
        vl, _ = to_local(v, keep=keep, partial=("model",))
        off = coordinate(mesh, "model") * ql.shape[1]
        return from_local(attention_core(ql, kl, vl, causal=causal,
                                         q_offset=off), mesh, pl)

    def core(_, ql, c, kl, vl):
        return _gqa_core(ql, kl, vl, c, write_index=None, kv_cap=kv_cap,
                         verify=False, causal=causal)
    return local_region(core, q, state=cache, args=(k, v))


def _gqa_core(q, k, v, cache, *, write_index, kv_cap, verify, causal):
    """Cache insert and attention of :func:`gqa_apply` from its rotated
    q [B, L, Hq, D] and k, v [B, L, Hkv, D]: (out, new_cache)."""
    n = q.shape[1]
    new_cache = None
    # the insert precedes the read, in stream order: rows of one call see
    # each other's writes
    if isinstance(cache, PagedKVCache):
        if write_index is None:
            write_index = paged_write_index(
                cache.table, cache.length, n, cache.k.shape[0] - 2,
                cache.k.shape[1])
        kp = _paged_insert(cache.k, k, cache.table, cache.length, write_index)
        vp = _paged_insert(cache.v, v, cache.table, cache.length, write_index)
        kv_len = cache.length + n
        new_cache = PagedKVCache(kp, vp, cache.table, kv_len)
        if n == 1:
            out = paged_attn(q[:, 0], kp, vp, cache.table, kv_len)[:, None]
        else:
            attend = paged_verify_attn if verify else paged_prefill_attn
            with part("attn.core"):
                out = attend(q, kp, vp, cache.table, cache.length, kv_len)
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
        out = attention_core(q, k, v, causal=causal)
    return out, new_cache


def _mla_qkr(params: dict, x: torch.Tensor, cfg: ArchConfig,
             rope: tuple[torch.Tensor, torch.Tensor]):
    """MLA's low-rank query (q_nope [B, L, H, nope], rotated q_rope [B, L,
    H, rope]), its compressed latent c_kv [B, L, r] and the shared rotated
    rope key k_rope [B, L, rope]; ``rope`` holds the tables at
    ``qk_rope_head_dim``."""
    m = cfg.mla
    cq = rmsnorm(params["dq_norm"], dense(params["dq"], x), cfg.norm_eps)
    q = dense(params["uq"], cq)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rotate(q[..., m.qk_nope_head_dim:], *rope)
    c_kv = rmsnorm(params["dkv_norm"], dense(params["dkv"], x),
                   cfg.norm_eps)
    k_rope = rotate(dense(params["kr"], x)[:, :, None, :], *rope)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor | None = None,
              rope: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache: KVCache | PagedKVCache | None = None,
              write_index=None, kv_cap: int | None = None,
              verify: bool = False, causal: bool = True):
    """Multi-head latent attention on JAX's absorbed path: the cache holds
    the latent ``c_kv`` (``cache.k``) and the shared rope key
    (``cache.v``) only; W_uk is absorbed into the query, the keys are
    ``[c_kv ; k_rope]`` over one shared head and the values ``c_kv``, and
    the latent output goes through W_uv, then ``o``.

    Dense stripes: written as :func:`gqa_apply` writes them (writes JAX
    drops land in the sink row) and read over their first ``kv_cap`` rows
    (JAX's ``_decode_policy().kv_cap``), or ``length + L`` for an int
    offset.  Paged pools: written through :func:`paged_write_index` (which
    needs no head axis) and read through :func:`gather_pages` of the
    table with every id past ``n_pages`` clamped to the sentinel's zero
    page, so an unallocated entry never reads the sink; masked by
    ``kv_len``.  Cache-free: :func:`attention_core`, masked by ``causal``;
    a cache's call is always causal.  MLA takes no ``kv_override``, as in
    JAX.  ``verify``
    changes nothing: JAX's verify is the same L = k+1 call.  Returns (y,
    new_cache)."""
    m = cfg.mla
    if rope is None:
        rope = rope_tables(positions, m.qk_rope_head_dim, cfg.rope_theta)
    if is_sharded(x):
        # the latent path runs on the batch shard, its weights gathered
        if isinstance(cache, PagedKVCache):
            raise NotImplementedError("the sharded path serves dense "
                                      "stripes, as JAX's decode step")
        y = local_region(
            lambda p, xl, c, rl: mla_apply(p, xl, cfg, rope=rl, cache=c,
                                           kv_cap=kv_cap, causal=causal),
            x, params=params, state=cache, args=(rope,))
        return y, None if cache is None else KVCache(
            cache.k, cache.v, cache.length + x.shape[1])
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, rope)
    q_lat = torch.einsum("bthq,rhq->bthr", q_nope,
                         params["uk"]["w"].to(x.dtype))    # [B,L,H,r]
    n = x.shape[1]
    new_cache, kv_len, q_offset = None, None, 0
    if isinstance(cache, PagedKVCache):
        n_live = cache.k.shape[0] - 2
        if write_index is None:
            write_index = paged_write_index(
                cache.table, cache.length, n, n_live, cache.k.shape[1])
        ckv = _paged_insert(cache.k, c_kv, cache.table, cache.length,
                            write_index)
        krp = _paged_insert(cache.v, k_rope, cache.table, cache.length,
                            write_index)
        kv_len, q_offset = cache.length + n, cache.length
        new_cache = PagedKVCache(ckv, krp, cache.table, kv_len)
        table = cache.table.clamp(max=n_live)
        c_kv_all = gather_pages(ckv, table).to(x.dtype)
        k_rope_all = gather_pages(krp, table).to(x.dtype)
    elif cache is not None:
        ckv = _cache_insert(cache.k, c_kv, cache.length, write_index)
        krc = _cache_insert(cache.v, k_rope, cache.length, write_index)
        kv_len, q_offset = cache.length + n, cache.length
        new_cache = KVCache(ckv, krc, kv_len)
        cap = ckv.shape[1] - 1                 # the sink row is never read
        if kv_cap is not None:
            cap = min(cap, kv_cap)
        if not isinstance(kv_len, torch.Tensor) or kv_len.dim() == 0:
            cap = min(cap, int(kv_len))
        c_kv_all = ckv[:, :cap].to(x.dtype)
        k_rope_all = krc[:, :cap].to(x.dtype)
    else:
        c_kv_all, k_rope_all = c_kv, k_rope
    k_full = torch.cat([c_kv_all, k_rope_all], dim=-1)[:, :, None, :]
    q_full = torch.cat([q_lat, q_rope], dim=-1)             # [B,L,H,r+rope]
    scale_fix = math.sqrt(q_full.shape[-1]) / math.sqrt(
        m.qk_nope_head_dim + m.qk_rope_head_dim)
    out_lat = attention_core(q_full * scale_fix, k_full,
                             c_kv_all[:, :, None, :],
                             causal=causal or cache is not None,
                             q_offset=q_offset, kv_len=kv_len)  # [B,L,H,r]
    out = torch.einsum("bthr,rhv->bthv", out_lat,
                       params["uv"]["w"].to(x.dtype))
    return dense(params["o"], out, n_in=2), new_cache


def attention_apply(params: dict, x: torch.Tensor, cfg: ArchConfig, **kw):
    """The layer's attention by the config's kind, as JAX's dispatch."""
    if cfg.attn is AttnKind.MLA:
        return mla_apply(params, x, cfg, **kw)
    return gqa_apply(params, x, cfg, **kw)
