"""GQA decoder over a KV cache, from :mod:`repro.models.transformer`:
DENSE blocks (attention and a gated MLP) and MOE blocks (attention and the
routed experts of :mod:`.moe`).

Parameters keep the JAX layout: each segment's leaves are stacked over its
layers (``[n_layers, ...]``), and the JAX ``lax.scan`` over a segment
becomes a Python loop that indexes layer ``i`` of every stacked leaf (a
view, no copy).  The caches are stacked the same way, dense stripes as
``[n_layers, B, max_len + 1, Hkv, D]`` and paged pools as
``[n_layers, n_pages + 1, page_size, Hkv, D]``, and written in place.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, BlockKind
from ..device import resolve_device
from .attention import (KVCache, PagedKVCache, dense_write_index, gqa_apply,
                        paged_write_index)
from .init import _check_supported
from .layers import dense, embed, mlp, rmsnorm, rope_tables, unembed
from .moe import moe_apply


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> list:
    """One ``{"k", "v"}`` stripe per segment, stacked over its layers, each
    ``[layers, batch, max_len + 1, kv_heads, head_dim]``: ``max_len`` rows
    per slot plus the sink row that takes writes JAX would drop (see
    :mod:`.attention`)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    shape = (batch, max_len + 1, cfg.kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros((seg.count,) + shape, dtype=dtype, device=dev),
             "v": torch.zeros((seg.count,) + shape, dtype=dtype, device=dev)}
            for seg in cfg.resolved_segments()]


def init_paged_caches(cfg: ArchConfig, batch: int, n_pages: int,
                      page_size: int, dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda") -> list:
    """One ``{"k", "v"}`` pool per segment, stacked over its layers, each
    ``[layers, n_pages + 1, page_size, kv_heads, head_dim]``: ``n_pages``
    live pages shared by every slot through the page table, plus the sink
    page that takes masked-out writes (see :mod:`.attention`).  ``batch``
    is unused by attention pools; it is kept for the JAX signature."""
    _check_supported(cfg)
    dev = resolve_device(device)
    shape = (n_pages + 1, page_size, cfg.kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros((seg.count,) + shape, dtype=dtype, device=dev),
             "v": torch.zeros((seg.count,) + shape, dtype=dtype, device=dev)}
            for seg in cfg.resolved_segments()]


def block_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                kind: BlockKind, *, rope,
                cache: KVCache | PagedKVCache | None = None,
                write_index=None, kv_cap: int | None = None):
    """Pre-norm attention block, then the gated MLP (DENSE) or the routed
    experts (MOE); returns (y, new_cache)."""
    h, new_cache = gqa_apply(params["attn"],
                             rmsnorm(params["norm1"], x, cfg.norm_eps), cfg,
                             rope=rope, cache=cache, write_index=write_index,
                             kv_cap=kv_cap)
    x = x + h
    z = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if kind is BlockKind.MOE:
        h = moe_apply(params["moe"], z, cfg, cfg.activation)
    else:
        h = mlp(params["mlp"], z, cfg.activation)
    return x + h, new_cache


def _layer(stacked, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            caches: list | None = None, cache_len=None,
            dtype: torch.dtype = torch.bfloat16,
            pages: torch.Tensor | None = None, kv_cap: int | None = None):
    """Returns (hidden [B, L, D], caches).

    ``batch["tokens"]``: [B, L] int.  With ``caches``, row b's L tokens sit
    at absolute positions ``cache_len[b] + t``: positions drive RoPE and the
    causal mask, K/V land past the resident prefix, and attention reads the
    prefix.  The caches are updated in place and returned.

    - Dense stripes (:func:`init_caches`, no ``pages``): ``cache_len`` is an
      int (0 for a prompt prefill) or per-slot [B] int32 (decode).
      ``kv_cap`` bounds the rows a one-token call reads.
    - Paged pools (:func:`init_paged_caches`) with ``pages`` ([B, P] int32
      page table) and per-slot ``cache_len`` [B] int32: a prompt prefill
      (``cache_len`` 0), a suffix prefill, a one-token decode and a k+1
      verify are all this one call.

    Without caches the call is a plain causal forward.  (The JAX forward
    also returns the MoE blocks' auxiliary loss, which serving does not
    read.)  A MOE block's capacity counts every row and position of the
    call, idle and padding rows included, as in JAX.
    """
    _check_supported(cfg)
    per_slot = isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1
    if caches is not None and cache_len is None:
        raise ValueError("caches need cache_len")
    if pages is not None and not per_slot:
        raise ValueError("paged caches need per-slot cache_len [B]")
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, dtype)
    length = x.shape[1]
    steps = torch.arange(length, device=x.device)
    if per_slot:
        positions = cache_len.reshape(-1, 1) + steps[None, :]
    elif cache_len is not None:
        positions = int(cache_len) + steps
    else:
        positions = steps
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    index = None
    if caches is not None and pages is not None:
        # every layer writes its K/V at the same pool addresses
        n_live, ps = caches[0]["k"].shape[1] - 1, caches[0]["k"].shape[2]
        index = paged_write_index(pages, cache_len, length, n_live, ps)
    elif caches is not None and per_slot:
        index = dense_write_index(cache_len, length,
                                  caches[0]["k"].shape[2] - 1)
    for si, seg in enumerate(cfg.resolved_segments()):
        stacked = params["segments"][si]
        for i in range(seg.count):
            cache = None
            if caches is not None and pages is not None:
                cache = PagedKVCache(caches[si]["k"][i], caches[si]["v"][i],
                                     pages, cache_len)
            elif caches is not None:
                cache = KVCache(caches[si]["k"][i], caches[si]["v"][i],
                                cache_len)
            x, _ = block_apply(_layer(stacked, i), x, cfg, seg.kind,
                               rope=rope, cache=cache, write_index=index,
                               kv_cap=kv_cap)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


def logits_fn(params: dict, hidden: torch.Tensor, cfg: ArchConfig):
    if cfg.tied_embeddings:
        return unembed(params["embed"], hidden)
    return dense(params["lm_head"], hidden.float())
