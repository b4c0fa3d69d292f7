"""Decoder over a KV cache, from :mod:`repro.models.transformer`: DENSE
blocks (attention and an MLP), MOE blocks (attention and the routed
experts of :mod:`.moe`), with GQA or multi-head latent attention, SSM
blocks (Mamba-2, :mod:`.ssm`) and SHARED_ATTN segments, where one DENSE
``shared_block`` is applied at every occurrence (zamba2).  An
encoder-decoder (whisper) normalises with LayerNorm and adds a
cross-attention branch to each decoder layer over the keys and values of
:func:`encode`; a vision model's stub patch embeddings replace the first
positions of the embedded prompt (internvl2).

Parameters keep the JAX layout: each segment's leaves are stacked over its
layers (``[n_layers, ...]``), and the JAX ``lax.scan`` over a segment
becomes a Python loop that indexes layer ``i`` of every stacked leaf (a
view, no copy).  The caches are stacked the same way, dense stripes as
``[n_layers, B, max_len + 1, Hkv, D]`` and paged pools as
``[n_layers, n_pages + 2, page_size, Hkv, D]`` (MLA: the latent and the
rope key, ``[.., r]`` and ``[.., rope]``, no head axis; a shared segment
its own ``n_layers = 1`` stripe or pool: the weights are shared, the
caches are not), and written in place.  An SSM segment's cache is per
slot in both layouts, ``{"conv": [n_layers, B, d_conv - 1, d_xbc],
"state": [n_layers, B, H, P, N]}`` (float32 state): a recurrent state is
O(1) in the sequence, so there is nothing to page.

The training loss is :func:`lm_loss`: next-token cross-entropy with JAX's
z-loss, computed :data:`LOSS_CHUNK` positions at a time
(:func:`chunked_xent`) so that the [B, L, V] float32 logits never exist
whole, plus deepseek's multi-token-prediction term and the MoE blocks'
load-balance term.  ``forward(remat=True)`` recomputes each layer in the
backward (``torch.utils.checkpoint``) instead of keeping its activations,
as JAX's ``jax.checkpoint`` over the scanned layer does.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, AttnKind, BlockKind
from ..device import resolve_device
from ..distributed.act_sharding import (as_dtensor, batch_sharded, constrain,
                                        constrain_btd, coordinate,
                                        from_local, is_sharded, to_local)
from .attention import (KVCache, PagedKVCache, attention_apply,
                        dense_write_index, paged_write_index)
from .init import ATTN_KINDS, _check_supported
from .layers import (dense, embed, layernorm, mla_rope_tables, mlp,
                     rmsnorm, rope_tables, sinusoidal_positions, unembed)
from .moe import moe_apply
from ..parthook import part
from .ssm import init_cache as init_ssm_cache, ssm_apply

LOSS_CHUNK = 1024           # positions a chunk of the LM loss, as in JAX


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


def _stacked_caches(cfg: ArchConfig, lead: tuple[int, int], batch: int,
                    dtype, device) -> list:
    """Attention segments a ``lead`` stripe or pool a layer, SSM segments
    :func:`~.ssm.init_cache` at ``batch`` slots a layer; on the ``meta``
    device, shapes only (the dry-run's input specs)."""
    _check_supported(cfg)
    dev = (torch.device(device) if torch.device(device).type == "meta"
           else resolve_device(device))
    caches = []
    for seg in cfg.resolved_segments():
        if seg.kind is BlockKind.SSM:
            one = init_ssm_cache(cfg, batch, dtype, "meta")   # shapes
            caches.append({name: torch.zeros((seg.count,) + t.shape,
                                             dtype=t.dtype, device=dev)
                           for name, t in one.items()})
            continue
        kshape, vshape = _attn_cache_shape(cfg, lead)
        caches.append({
            "k": torch.zeros((seg.count,) + kshape, dtype=dtype, device=dev),
            "v": torch.zeros((seg.count,) + vshape, dtype=dtype, device=dev)})
    return caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> list:
    """One ``{"k", "v"}`` stripe per segment, stacked over its layers, each
    ``[layers, batch, max_len + 1, ...]`` (``...`` the per-token shape of
    :func:`_attn_cache_shape`): ``max_len`` rows per slot plus the sink
    row that takes writes JAX would drop (see :mod:`.attention`).  SSM
    segments hold their per-slot conv window and state."""
    return _stacked_caches(cfg, (batch, max_len + 1), batch, dtype, device)


def init_paged_caches(cfg: ArchConfig, batch: int, n_pages: int,
                      page_size: int, dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda") -> list:
    """One ``{"k", "v"}`` pool per segment, stacked over its layers, each
    ``[layers, n_pages + 2, page_size, ...]``: ``n_pages`` live pages
    shared by every slot through the page table, then the sentinel's page,
    which stays zero for reads through unallocated entries, and the sink
    page that takes masked-out writes (see :mod:`.attention`).  SSM
    segments keep their per-slot state, ``batch`` slots of it, as in
    JAX."""
    return _stacked_caches(cfg, (n_pages + 2, page_size), batch, dtype,
                           device)


def cache_bytes(cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """What serving holds for ``cfg``: ``kv_token`` bytes of K/V a token
    over every attention layer (0 for an attention-free model) and
    ``ssm_slot`` bytes of conv window and state a slot over every SSM
    layer (0 without SSM segments)."""
    width = torch.empty((), dtype=dtype).element_size()
    kv = ssm = 0
    for seg in cfg.resolved_segments():
        if seg.kind is BlockKind.SSM:
            one = init_ssm_cache(cfg, 1, dtype, "meta")
            ssm += seg.count * sum(t.numel() * t.element_size()
                                   for t in one.values())
        else:
            kshape, vshape = _attn_cache_shape(cfg, ())
            kv += seg.count * width * (math.prod(kshape) + math.prod(vshape))
    return {"kv_token": kv, "ssm_slot": ssm}


def _norm(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in an encoder-decoder (every norm of it), RMSNorm in every
    other model, as JAX's ``_norm``."""
    if cfg.enc_dec:
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


def block_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                kind: BlockKind, *, rope,
                cache: KVCache | PagedKVCache | dict | None = None,
                write_index=None, kv_cap: int | None = None,
                verify: bool = False, lengths=None, with_aux: bool = False,
                cross_kv=None, causal: bool = True):
    """Pre-norm attention block (GQA or MLA, by the config), then the MLP
    (DENSE) or the routed experts (MOE); or a pre-norm SSM block, whose
    ``cache`` is a layer's ``{"conv", "state"}`` and whose prefill ends
    each row at ``lengths`` (see :func:`~.ssm.ssm_apply`).  A decoder
    layer of an encoder-decoder (one with ``cross`` leaves) attends over
    ``cross_kv`` (the encoder's (k, v)) after its self-attention, when
    given; ``causal`` masks a cache-free self-attention (off in the
    encoder).  Returns (y, new_cache), and with ``with_aux`` (y,
    new_cache, aux): the MOE block's load-balance term, 0 for the other
    kinds."""
    x = constrain_btd(x)   # pin activations to batch sharding (a policy)
    aux = None
    if with_aux:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind is BlockKind.SSM:
        h = ssm_apply(params["ssm"], _norm(cfg, params["norm"], x),
                      cfg, cache=cache, lengths=lengths)
        return (x + h, cache) + ((aux,) if with_aux else ())
    z = _norm(cfg, params["norm1"], x)
    with part("attn"):
        h, new_cache = attention_apply(
            params["attn"], z, cfg, rope=rope, cache=cache,
            write_index=write_index, kv_cap=kv_cap, verify=verify,
            causal=causal)
    x = x + h
    if "cross" in params and cross_kv is not None:
        h, _ = attention_apply(params["cross"],
                               _norm(cfg, params["norm_x"], x), cfg,
                               causal=False, kv_override=cross_kv)
        x = x + h
    z = _norm(cfg, params["norm2"], x)
    if kind is BlockKind.MOE and with_aux:
        h, aux = moe_apply(params["moe"], z, cfg, cfg.activation,
                           with_aux=True)
    elif kind is BlockKind.MOE:
        h = moe_apply(params["moe"], z, cfg, cfg.activation)
    else:
        with part("mlp"):
            h = mlp(params["mlp"], z, cfg.activation)
    return (x + h, new_cache) + ((aux,) if with_aux else ())


def _rope(cfg: ArchConfig, positions: torch.Tensor):
    """RoPE tables at ``positions``: MLA rotates only its rope slice of
    each head and its shared key, at YaRN's frequencies where its config
    has them."""
    if cfg.attn is AttnKind.MLA:
        return mla_rope_tables(positions, cfg.mla, cfg.rope_theta)
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _layer(stacked, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig, *,
           remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Whisper's encoder over stub frame embeddings ``frames`` [B, Te, D],
    as JAX's ``encode``: the float32 sinusoid cast to the frames' dtype
    and added, the stacked ``encoder`` blocks non-causal and rotated by
    RoPE at positions ``arange(Te)`` (JAX's self-attention rotates
    whenever it has no override), ``enc_norm``, then the ``cross_k`` and
    ``cross_v`` projections.  Returns (k, v), each [B, Te, Hkv, D], the
    ``cross_kv`` of every decoder layer.  ``remat`` runs each block under
    ``torch.utils.checkpoint``, as :func:`forward` does its layers."""
    te = frames.shape[1]
    x = frames + sinusoidal_positions(te, cfg.d_model,
                                      frames.device).to(frames.dtype)
    rope = _rope(cfg, torch.arange(te, device=frames.device))
    stacked = params["encoder"]
    for i in range(cfg.n_encoder_layers):
        args = (_layer(stacked, i), x, cfg, BlockKind.DENSE)
        if remat:
            x = checkpoint(block_apply, *args, rope=rope, causal=False,
                           use_reentrant=False, preserve_rng_state=False)[0]
        else:
            x = block_apply(*args, rope=rope, causal=False)[0]
    x = _norm(cfg, params["enc_norm"], x)
    return dense(params["cross_k"], x), dense(params["cross_v"], x)


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            caches: list | None = None, cache_len=None,
            dtype: torch.dtype = torch.bfloat16,
            pages: torch.Tensor | None = None, kv_cap: int | None = None,
            verify: bool = False, lengths: torch.Tensor | None = None,
            remat: bool = False, with_aux: bool = False):
    """Returns (hidden [B, L, D], caches), and with ``with_aux`` (hidden,
    caches, aux): the MOE blocks' load-balance terms summed over the
    layers (float32, 0 without MOE blocks), as JAX's forward returns.

    ``batch["tokens"]``: [B, L] int.  A vision model's
    ``batch["vision_embeds"]`` [B, Tv, D] replaces the first Tv embedded
    tokens (a prompt shorter than Tv leaves Tv positions, as JAX's concat
    does).  An encoder-decoder's decoder layers attend over
    ``batch["cross_kv"]`` ((k, v) from :func:`encode`), or over the
    encoding of ``batch["encoder_frames"]`` [B, Te, D], computed once a
    call; with neither they skip cross-attention, as JAX's do.  With
    ``caches``, row b's L tokens sit
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

    SSM segments (mamba2, zamba2) carry a per-slot state instead: a
    one-token call with caches continues it, any other call is a prefill
    from a zero state, and ``lengths`` ([B], a prefill's per-row prompt
    lengths) stops each row's recurrence at its own length, so that a
    row's state does not take in the padding of a mixed-length batch
    (JAX's runs through it; see :mod:`.ssm`).

    Without caches the call is a plain causal forward; ``remat`` (taken
    only then) runs each layer under ``torch.utils.checkpoint``, so the
    backward recomputes the layer from its input.  A MOE block's capacity
    counts every row and position of the call, idle and padding rows
    included, as in JAX.
    """
    _check_supported(cfg)
    per_slot = isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1
    if caches is not None and cache_len is None:
        raise ValueError("caches need cache_len")
    if pages is not None and not per_slot:
        raise ValueError("paged caches need per-slot cache_len [B]")
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, dtype)
    if cfg.frontend.value == "vision" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    cross_kv = batch.get("cross_kv")
    if cfg.enc_dec and cross_kv is None and "encoder_frames" in batch:
        cross_kv = encode(params, batch["encoder_frames"].to(dtype), cfg,
                          remat=remat and caches is None)
    length = x.shape[1]
    steps = torch.arange(length, device=x.device)
    if per_slot:
        positions = cache_len.reshape(-1, 1) + steps[None, :]
    elif cache_len is not None:
        positions = int(cache_len) + steps
    else:
        positions = steps
    segs = cfg.resolved_segments()
    # the first attention segment's stripe or pool (None: attention-free)
    attn_cache = next((c for seg, c in zip(segs, caches or ())
                       if seg.kind in ATTN_KINDS), None)
    rope = index = None
    if cfg.attn is not AttnKind.NONE:
        rope = _rope(cfg, positions)
    if is_sharded(x):
        pass        # the sharded cores write through their local tensors
    elif attn_cache is not None and pages is not None:
        # every layer writes its K/V at the same pool addresses; the pools
        # lead [layers, n_pages + 2, page_size] for GQA and MLA alike
        n_live, ps = attn_cache["k"].shape[1] - 2, attn_cache["k"].shape[2]
        index = paged_write_index(pages, cache_len, length, n_live, ps)
    elif attn_cache is not None and per_slot:
        index = dense_write_index(cache_len, length,
                                  attn_cache["k"].shape[2] - 1)
    remat = remat and caches is None
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if with_aux else None)
    if with_aux and is_sharded(x):        # a DTensor leads every sum
        aux = as_dtensor(aux, x.device_mesh)
    for si, seg in enumerate(segs):
        kind, stacked = seg.kind, params["segments"][si]
        if kind is BlockKind.SHARED_ATTN:   # one weight set, its own cache
            kind, stacked = BlockKind.DENSE, None
        for i in range(seg.count):
            cache = None
            if caches is not None and kind is BlockKind.SSM:
                cache = {name: t[i] for name, t in caches[si].items()}
            elif caches is not None and pages is not None:
                cache = PagedKVCache(caches[si]["k"][i], caches[si]["v"][i],
                                     pages, cache_len)
            elif caches is not None:
                cache = KVCache(caches[si]["k"][i], caches[si]["v"][i],
                                cache_len)
            layer = (params["shared_block"] if stacked is None
                     else _layer(stacked, i))
            kw = dict(rope=rope, cache=cache, write_index=index,
                      kv_cap=kv_cap, verify=verify, lengths=lengths,
                      with_aux=with_aux, cross_kv=cross_kv)
            if remat:
                # nothing in a layer draws random numbers: no RNG to keep
                out = checkpoint(block_apply, layer, x, cfg, kind, **kw,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = block_apply(layer, x, cfg, kind, **kw)
            x = out[0]
            if with_aux:
                aux = aux + out[2]
    hidden = _norm(cfg, params["final_norm"], x)
    return (hidden, caches, aux) if with_aux else (hidden, caches)


def logits_fn(params: dict, hidden: torch.Tensor, cfg: ArchConfig):
    if cfg.tied_embeddings:
        return unembed(params["embed"], hidden)
    return dense(params["lm_head"], hidden.float())


# ---------------------------------------------------------------------------
# the training loss
# ---------------------------------------------------------------------------

def _xent_chunk(params: dict, h: torch.Tensor, t: torch.Tensor,
                m: torch.Tensor, cfg: ArchConfig, z_loss: float):
    """(sum of masked nll, mask count) of one chunk, float32.  Sharded
    (DTensor ``h``): :func:`_xent_sums_sharded`."""
    logits = logits_fn(params, h, cfg)                  # [B, chunk, V] f32
    if is_sharded(logits):
        return _xent_sums_sharded(logits, t, m, z_loss)
    return _xent_sums(logits, t, m, z_loss)


def _xent_sums_sharded(logits, t, m, z_loss: float):
    """:func:`_xent_sums` of DTensor logits [B, chunk, V] vocab-parallel
    (Megatron's): with the vocab split over ``model`` each rank reduces
    its own columns (the max, the exp-sum and the target's logit, all
    [B, chunk]) and one all-reduce each combines them, so the logits are
    never gathered; each batch shard's sums are then added across the
    shards.  Logits replicated over ``model`` reduce locally."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    keep = batch_sharded(logits)
    split = "model" in names and logits.placements[
        names.index("model")] == Shard(2)
    lg, _ = to_local(logits, keep=keep + (("model",) if split else ()))
    tl = to_local(t, keep=batch_sharded(t))[0]
    ml = to_local(m, keep=batch_sharded(m))[0]
    if split:
        sums = _vocab_parallel_sums(lg, tl, ml, z_loss, mesh, keep)
    else:
        sums = _xent_sums(lg, tl, ml, z_loss)
    part = [Partial() if n in keep else Replicate() for n in names]
    rep = [Replicate()] * mesh.ndim
    return tuple(from_local(v, mesh, part).redistribute(mesh, rep)
                 for v in sums)


def _vocab_parallel_sums(lg: torch.Tensor, t: torch.Tensor,
                         m: torch.Tensor, z_loss: float, mesh, keep):
    """:func:`_xent_sums` of this rank's vocab columns ``lg`` [b, chunk,
    V / model] of logits split over ``model``: the row max, exp-sum and
    target logit each reduced over ``model`` with one all-reduce."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = mesh.mesh_dim_names
    row_pl = [Shard(0) if n in keep else Replicate() for n in names]
    src = {op: [Partial(op) if n == "model" else p
                for n, p in zip(names, row_pl)] for op in ("max", "sum")}

    def over_vocab(v, op="sum"):           # [b, chunk] reduced over model
        return from_local(v, mesh, src[op]).redistribute(mesh, row_pl) \
            .to_local()
    top = over_vocab(lg.detach().amax(dim=-1), "max")
    lse = torch.log(over_vocab(torch.exp(lg - top[..., None]).sum(-1))) + top
    ids = t.long() - coordinate(mesh, "model") * lg.shape[-1]
    hit = (ids >= 0) & (ids < lg.shape[-1])
    tgt = over_vocab(torch.where(hit, lg.gather(
        -1, ids.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0], 0.0))
    nll = (lse - tgt) + z_loss * torch.square(lse)
    m = m.float()
    return torch.sum(nll * m), torch.sum(m)


def _xent_sums(logits: torch.Tensor, t: torch.Tensor, m: torch.Tensor,
               z_loss: float):
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, t[..., None].long())[..., 0]
    nll = (lse - tgt) + z_loss * torch.square(lse)
    m = m.float()
    return torch.sum(nll * m), torch.sum(m)


def chunked_xent(params: dict, hidden: torch.Tensor, targets: torch.Tensor,
                 cfg: ArchConfig, mask: torch.Tensor | None = None,
                 chunk: int = LOSS_CHUNK, z_loss: float = 1e-4):
    """Cross-entropy with JAX's z-loss, ``sum((lse - logit[target] + z
    lse^2) * mask) / max(count, 1)``, over ``chunk`` positions at a time.
    Under autograd each chunk runs under ``torch.utils.checkpoint``, so
    only one chunk's float32 logits is live in the forward or in the
    backward.  The last chunk is the remainder: JAX pads it with masked
    positions, which add exactly 0."""
    b, length, _ = hidden.shape
    if mask is None:
        mask = torch.ones((b, length), dtype=torch.bool,
                          device=hidden.device)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    if is_sharded(hidden):                # a DTensor leads every sum
        loss_sum, count = (as_dtensor(t, hidden.device_mesh)
                           for t in (loss_sum, count))
    for lo in range(0, length, chunk):
        part = (params, hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk],
                mask[:, lo:lo + chunk], cfg, z_loss)
        if torch.is_grad_enabled() and not is_sharded(hidden):
            s, n = checkpoint(_xent_chunk, *part, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            s, n = _xent_chunk(*part)
        loss_sum, count = loss_sum + s, count + n
    return loss_sum / torch.clamp(count, min=1.0)


def _roll(tokens, shift: int):
    """``torch.roll`` along the sequence; a DTensor's batch shards roll on
    their own (the sequence dim is never sharded)."""
    if is_sharded(tokens):
        return from_local(torch.roll(tokens.to_local(), shift, dims=1),
                          tokens.device_mesh, tokens.placements)
    return torch.roll(tokens, shift, dims=1)


def lm_loss(params: dict, batch: dict, cfg: ArchConfig, *,
            dtype: torch.dtype = torch.bfloat16, remat: bool = False):
    """Next-token loss (targets the tokens shifted by one, the last
    position masked), plus deepseek's multi-token-prediction term (the
    ``mtp_block`` on the final-normed hidden, then ``mtp_norm``, 0.3 of the
    cross-entropy against the tokens shifted by two) and 0.01 of the MoE
    load-balance term, as JAX's ``lm_loss``.  ``batch`` goes to
    :func:`forward` as it is, so the vision prefix's positions take
    next-token targets too, and the encoder's frames are encoded there.
    A float32 scalar."""
    tokens = batch["tokens"]
    hidden, _, aux = forward(params, batch, cfg, dtype=dtype, remat=remat,
                             with_aux=True)
    targets = _roll(tokens, -1)
    mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    mask[:, -1] = False
    mask2 = None
    if cfg.mtp:
        mask2 = mask.clone()
        mask2[:, -2] = False
    if is_sharded(hidden):     # the masks onto the tokens' batch shards
        mesh = hidden.device_mesh
        mask, mask2 = (None if mk is None else constrain(
            as_dtensor(mk, mesh), ("batch", None)) for mk in (mask, mask2))
    loss = chunked_xent(params, hidden, targets, cfg, mask)
    if cfg.mtp:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h2, _ = block_apply(params["mtp_block"], hidden, cfg,
                            BlockKind.DENSE, rope=_rope(cfg, positions))
        h2 = _norm(cfg, params["mtp_norm"], h2)
        loss = loss + 0.3 * chunked_xent(
            params, h2, _roll(tokens, -2), cfg, mask2)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux
    return loss
