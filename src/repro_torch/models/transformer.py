"""Dense GQA decoder over a paged KV cache, from
:mod:`repro.models.transformer`.

Parameters keep the JAX layout: each segment's leaves are stacked over its
layers (``[n_layers, ...]``), and the JAX ``lax.scan`` over a segment
becomes a Python loop that indexes layer ``i`` of every stacked leaf (a
view, no copy).  The paged pools are stacked the same way
(``[n_layers, n_pages + 1, page_size, Hkv, D]``) and written in place.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .attention import PagedKVCache, gqa_apply, paged_write_index
from .init import _check_supported
from .layers import dense, embed, mlp, rmsnorm, rope_tables, unembed


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


def block_apply(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
                rope, cache: PagedKVCache | None = None, write_index=None):
    """Pre-norm attention block and gated MLP; returns (y, new_cache)."""
    h, new_cache = gqa_apply(params["attn"],
                             rmsnorm(params["norm1"], x, cfg.norm_eps), cfg,
                             rope=rope, cache=cache, write_index=write_index)
    x = x + h
    h = mlp(params["mlp"], rmsnorm(params["norm2"], x, cfg.norm_eps),
            cfg.activation)
    return x + h, new_cache


def _layer(stacked, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            caches: list | None = None,
            cache_len: torch.Tensor | None = None,
            dtype: torch.dtype = torch.bfloat16,
            pages: torch.Tensor | None = None):
    """Returns (hidden [B, L, D], caches).

    ``batch["tokens"]``: [B, L] int.  With ``caches`` (the pools of
    :func:`init_paged_caches`) and ``pages`` ([B, P] int32 page table),
    row b's L tokens sit at absolute positions ``cache_len[b] + t``
    (``cache_len`` per slot, [B] int32): positions drive RoPE and the
    causal mask, K/V land past the resident prefix, and attention reads
    the prefix through the table.  A prompt prefill (``cache_len`` 0), a
    suffix prefill, a one-token decode and a k+1 verify are all this one
    call.  Without caches the call is a plain causal forward.  The caches
    are updated in place and returned.  (The JAX forward also returns an
    auxiliary loss, which only MoE blocks make nonzero.)
    """
    _check_supported(cfg)
    if caches is not None and (pages is None or cache_len is None
                               or cache_len.dim() != 1):
        raise ValueError("the port's caches are paged: pass them with "
                         "pages and per-slot cache_len [B]")
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, dtype)
    length = x.shape[1]
    steps = torch.arange(length, device=x.device)
    if cache_len is None:
        positions = steps
    else:
        positions = cache_len.reshape(-1, 1) + steps[None, :]
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    index = None
    if caches is not None:
        # every layer writes its K/V at the same pool addresses
        n_live, ps = caches[0]["k"].shape[1] - 1, caches[0]["k"].shape[2]
        index = paged_write_index(pages, cache_len, length, n_live, ps)
    for si, seg in enumerate(cfg.resolved_segments()):
        stacked = params["segments"][si]
        for i in range(seg.count):
            cache = None
            if caches is not None:
                cache = PagedKVCache(caches[si]["k"][i], caches[si]["v"][i],
                                     pages, cache_len)
            x, _ = block_apply(_layer(stacked, i), x, cfg, rope=rope,
                               cache=cache, write_index=index)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


def logits_fn(params: dict, hidden: torch.Tensor, cfg: ArchConfig):
    if cfg.tied_embeddings:
        return unembed(params["embed"], hidden)
    return dense(params["lm_head"], hidden.float())
