"""Decoder over a KV cache, from :mod:`repro.models.transformer`: DENSE
blocks (attention and an MLP) and MOE blocks (attention and the routed
experts of :mod:`.moe`), with GQA or multi-head latent attention.

Parameters keep the JAX layout: each segment's leaves are stacked over its
layers (``[n_layers, ...]``), and the JAX ``lax.scan`` over a segment
becomes a Python loop that indexes layer ``i`` of every stacked leaf (a
view, no copy).  The caches are stacked the same way, dense stripes as
``[n_layers, B, max_len + 1, Hkv, D]`` and paged pools as
``[n_layers, n_pages + 2, page_size, Hkv, D]`` (MLA: the latent and the
rope key, ``[.., r]`` and ``[.., rope]``, no head axis), and written in
place.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, AttnKind, BlockKind
from ..device import resolve_device
from .attention import (KVCache, PagedKVCache, attention_apply,
                        dense_write_index, paged_write_index)
from .init import _check_supported
from .layers import dense, embed, mlp, rmsnorm, rope_tables, unembed
from .moe import moe_apply


def _attn_cache_shape(cfg: ArchConfig, lead: tuple[int, int]):
    """(k, v) shapes of one layer's cache behind ``lead``: GQA keys and
    values ``lead + (kv_heads, head_dim)``; MLA the latent ``lead +
    (kv_lora_rank,)`` and the shared rope key ``lead +
    (qk_rope_head_dim,)``, as JAX's ``_attn_cache_shape``."""
    if cfg.attn is AttnKind.MLA:
        return (lead + (cfg.mla.kv_lora_rank,),
                lead + (cfg.mla.qk_rope_head_dim,))
    shape = lead + (cfg.kv_heads, cfg.resolved_head_dim)
    return shape, shape


def _stacked_caches(cfg: ArchConfig, lead: tuple[int, int], dtype,
                    device) -> list:
    _check_supported(cfg)
    dev = resolve_device(device)
    kshape, vshape = _attn_cache_shape(cfg, lead)
    return [{"k": torch.zeros((seg.count,) + kshape, dtype=dtype, device=dev),
             "v": torch.zeros((seg.count,) + vshape, dtype=dtype, device=dev)}
            for seg in cfg.resolved_segments()]


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> list:
    """One ``{"k", "v"}`` stripe per segment, stacked over its layers, each
    ``[layers, batch, max_len + 1, ...]`` (``...`` the per-token shape of
    :func:`_attn_cache_shape`): ``max_len`` rows per slot plus the sink
    row that takes writes JAX would drop (see :mod:`.attention`)."""
    return _stacked_caches(cfg, (batch, max_len + 1), dtype, device)


def init_paged_caches(cfg: ArchConfig, batch: int, n_pages: int,
                      page_size: int, dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda") -> list:
    """One ``{"k", "v"}`` pool per segment, stacked over its layers, each
    ``[layers, n_pages + 2, page_size, ...]``: ``n_pages`` live pages
    shared by every slot through the page table, then the sentinel's page,
    which stays zero for reads through unallocated entries, and the sink
    page that takes masked-out writes (see :mod:`.attention`).  ``batch``
    is unused by attention pools; it is kept for the JAX signature."""
    return _stacked_caches(cfg, (n_pages + 2, page_size), dtype, device)


def block_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                kind: BlockKind, *, rope,
                cache: KVCache | PagedKVCache | None = None,
                write_index=None, kv_cap: int | None = None,
                verify: bool = False):
    """Pre-norm attention block (GQA or MLA, by the config), then the MLP
    (DENSE) or the routed experts (MOE); returns (y, new_cache)."""
    h, new_cache = attention_apply(
        params["attn"], rmsnorm(params["norm1"], x, cfg.norm_eps), cfg,
        rope=rope, cache=cache, write_index=write_index, kv_cap=kv_cap,
        verify=verify)
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
            pages: torch.Tensor | None = None, kv_cap: int | None = None,
            verify: bool = False):
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
      verify are all this one call; ``verify`` marks the last, whose
      attention takes the verify op's tuned launch.

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
    # MLA rotates only its rope slice of each head and its shared key
    rope_dim = (cfg.mla.qk_rope_head_dim if cfg.attn is AttnKind.MLA
                else cfg.resolved_head_dim)
    rope = rope_tables(positions, rope_dim, cfg.rope_theta)
    index = None
    if caches is not None and pages is not None:
        # every layer writes its K/V at the same pool addresses; the pools
        # lead [layers, n_pages + 2, page_size] for GQA and MLA alike
        n_live, ps = caches[0]["k"].shape[1] - 2, caches[0]["k"].shape[2]
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
                               kv_cap=kv_cap, verify=verify)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


def logits_fn(params: dict, hidden: torch.Tensor, cfg: ArchConfig):
    if cfg.tied_embeddings:
        return unembed(params["embed"], hidden)
    return dense(params["lm_head"], hidden.float())
