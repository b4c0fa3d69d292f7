"""Seeded parameter init with the shapes and scales of
:func:`repro.models.transformer.init_lm` (decoders with GQA or multi-head
latent attention and dense or routed-expert feed-forward blocks, Mamba-2
SSD blocks, a shared attention block, and whisper's encoder and
cross-attention).

The tree has the JAX layout, unwrapped (see ``repro.models.param.unwrap``):
layer-stacked ``segments`` whose leaves are ``[n_layers, ...]``, with a
``mlp`` in DENSE blocks, a ``moe`` (``init_moe``'s router, expert weights
and shared experts) in MOE blocks and ``init_ssm``'s leaves under ``ssm``
in SSM blocks; a SHARED_ATTN segment is ``{}``, its weights the one
unstacked DENSE ``shared_block`` that every occurrence applies (zamba2).
A ``noaux_tc`` router adds its correction ``bias`` [E] beside ``w``, and
a config holding a share of the experts has slabs of the held ones only
(``[held, D, F]``; the router stays ``[D, E]``).  An MLA model's
``attn`` holds ``init_mla``'s low-rank leaves, and a model with
multi-token prediction (deepseek-v3) also the unstacked DENSE
``mtp_block`` and ``mtp_norm``, which serving never reads (they belong to
the training loss).  An encoder-decoder (whisper) has LayerNorm leaves
(``scale`` and ``bias``) for every norm, a ``norm_x`` and a ``cross``
attention in each decoder layer, the stacked DENSE ``encoder`` (its
attention at ``kv_heads = n_heads``), ``enc_norm`` and the ``cross_k`` /
``cross_v`` projections that make the keys and values every cross layer
reads (so each layer's own ``cross`` k and v are never read, as in
JAX).  Values
come from a ``torch.Generator`` seeded explicitly, so they differ from the
JAX init's; parity tests feed both packages the JAX weights through
:mod:`repro_torch.models.bridge` instead.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig, AttnKind, BlockKind
from ..device import resolve_device
from . import param as pm
from .moe import held_experts
from .ssm import _dims as ssm_dims

FILL_CHUNK = 1 << 24    # values drawn at once by init_params (64 MiB fp32)


ATTN_KINDS = (BlockKind.DENSE, BlockKind.MOE, BlockKind.SHARED_ATTN)


def _check_supported(cfg: ArchConfig) -> None:
    kinds = {s.kind for s in cfg.resolved_segments()}
    attends = bool(kinds & set(ATTN_KINDS))
    if (cfg.attn not in ((AttnKind.GQA, AttnKind.MLA) if attends
                         else (AttnKind.NONE,))
            or (cfg.attn is AttnKind.MLA) != (cfg.mla is not None)
            or (BlockKind.MOE in kinds) != (cfg.moe is not None)
            or (BlockKind.SSM in kinds) != (cfg.ssm is not None)
            or (BlockKind.SHARED_ATTN in kinds) != bool(
                cfg.shared_attn_every)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs GQA and MLA decoders with dense "
            "and MoE blocks (a stub vision prefix or, with GQA, a stub "
            "audio encoder), and Mamba-2 stacks with or without a shared "
            "attention block")
    if cfg.enc_dec and cfg.attn is not AttnKind.GQA:
        raise NotImplementedError(f"{cfg.name}: cross-attention is GQA's")


def serves_in_float32(path: tuple[str, ...]) -> bool:
    """Leaves kept in float32 when the projections are stored in a lower
    serving dtype: norm scales and a LayerNorm's ``bias`` (the norms
    multiply and add in float32; a projection's bias is its ``b``, cast),
    the embedding (rows are gathered, then cast), the router and its
    ``noaux_tc`` correction bias (JAX routes with float32 logits from a
    float32 weight; the gate adds the bias in float32) and the untied
    read-out (JAX reads out in float32 from a float32 weight) and an SSM
    block's ``a_log`` and ``dt_bias`` (JAX adds them to float32 ``dt``)."""
    return (path[-1] in ("scale", "a_log", "dt_bias")
            or (path[-1] == "bias" and "norm" in path[-2])
            or path[:1] in (("embed",), ("lm_head",))
            or path[-2:] in (("router", "w"), ("router", "bias")))


def _spec(cfg: ArchConfig) -> dict:
    """The tree as leaf specs: ("normal", shape, std, axes), ("zeros",
    shape, axes), ("ones", shape, axes) or ("a_log", shape, axes)
    (``log(linspace(1, 16, H))`` in every layer); layer-stacked leaves
    lead with the layer count, which their logical ``axes`` (JAX's, from
    its init sites) leave out."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.kv_heads
    hd, f = cfg.resolved_head_dim, cfg.d_ff

    def dense(lead, fan_in, *shape, axes):
        return {"w": ("normal", lead + (fan_in,) + shape,
                      1 / math.sqrt(fan_in), axes)}

    def norm(lead, width):
        return {"scale": ("ones", lead + (width,), ("embed",))}

    def model_norm(lead):                  # _init_norm: LayerNorm if enc-dec
        out = norm(lead, d)
        if cfg.enc_dec:
            out["bias"] = ("zeros", lead + (d,), ("embed",))
        return out

    def gated_mlp(lead, width, gated=True):
        out = {"wi": dense(lead, d, width, axes=("embed", "mlp")),
               "wo": dense(lead, width, d, axes=("mlp", "embed"))}
        if gated:
            out["wg"] = dense(lead, d, width, axes=("embed", "mlp"))
        return out

    def attention(lead, hkv=hkv):
        if cfg.attn is AttnKind.MLA:       # init_mla
            m = cfg.mla
            ax = ("heads", "head_dim")
            return {"dq": dense(lead, d, m.q_lora_rank,
                                axes=("embed", "q_lora")),
                    "dq_norm": norm(lead, m.q_lora_rank),
                    "uq": dense(lead, m.q_lora_rank, hq,
                                m.qk_nope_head_dim + m.qk_rope_head_dim,
                                axes=("q_lora",) + ax),
                    "dkv": dense(lead, d, m.kv_lora_rank,
                                 axes=("embed", "kv_lora")),
                    "dkv_norm": norm(lead, m.kv_lora_rank),
                    "kr": dense(lead, d, m.qk_rope_head_dim,
                                axes=("embed", "head_dim")),
                    "uk": dense(lead, m.kv_lora_rank, hq,
                                m.qk_nope_head_dim, axes=("kv_lora",) + ax),
                    "uv": dense(lead, m.kv_lora_rank, hq, m.v_head_dim,
                                axes=("kv_lora",) + ax),
                    "o": {"w": ("normal", lead + (hq, m.v_head_dim, d),
                                1 / math.sqrt(hq * m.v_head_dim),
                                ax + ("embed",))}}
        attn = {}
        for name, heads, ax in (("q", hq, "heads"), ("k", hkv, "kv_heads"),
                                ("v", hkv, "kv_heads")):
            attn[name] = dense(lead, d, heads, hd,
                               axes=("embed", ax, "head_dim"))
            if cfg.qkv_bias:
                attn[name]["b"] = ("zeros", lead + (heads, hd),
                                   (ax, "head_dim"))
        attn["o"] = {"w": ("normal", lead + (hq, hd, d),
                           1 / math.sqrt(hq * hd),
                           ("heads", "head_dim", "embed"))}
        return attn

    def ssm(lead):                         # init_ssm
        d_inner, h, d_xbc = ssm_dims(cfg)
        return {"in_z": dense(lead, d, d_inner, axes=("embed", "mlp")),
                "in_xbc": dense(lead, d, d_xbc, axes=("embed", "mlp")),
                "in_dt": dense(lead, d, h, axes=("embed", "heads")),
                "conv_w": ("normal", lead + (cfg.ssm.d_conv, d_xbc), 0.2,
                           ("conv", "mlp")),
                "conv_b": ("zeros", lead + (d_xbc,), ("mlp",)),
                "a_log": ("a_log", lead + (h,), ("heads",)),
                "dt_bias": ("zeros", lead + (h,), ("heads",)),
                "d_skip": ("ones", lead + (h,), ("heads",)),
                "norm": norm(lead, d_inner),
                "out": dense(lead, d_inner, d, axes=("mlp", "embed"))}

    def block(lead, kind, cross=False, hkv=hkv):
        if kind is BlockKind.SSM:
            return {"norm": model_norm(lead), "ssm": ssm(lead)}
        out = {"norm1": model_norm(lead), "attn": attention(lead, hkv),
               "norm2": model_norm(lead)}
        if cross:
            out["norm_x"] = model_norm(lead)
            out["cross"] = attention(lead)
        if kind is BlockKind.MOE:
            m = cfg.moe
            e, fe = m.n_experts, m.d_ff_expert
            held = held_experts(cfg)        # the slabs of a chip's share
            moe = {"router": {"w": ("normal", lead + (d, e), 0.02,
                                    ("embed", "experts"))},
                   "wi": ("normal", lead + (held, d, fe), 1 / math.sqrt(d),
                          ("experts", "embed", "mlp")),
                   "wg": ("normal", lead + (held, d, fe), 1 / math.sqrt(d),
                          ("experts", "embed", "mlp")),
                   "wo": ("normal", lead + (held, fe, d),
                          1 / math.sqrt(fe), ("experts", "mlp", "embed"))}
            if m.router == "noaux_tc":
                # the correction bias over every expert, replicated,
                # drawn as the router is
                moe["router"]["bias"] = ("normal", lead + (e,), 0.02,
                                         (None,))
            if m.n_shared_experts:
                moe["shared"] = gated_mlp(
                    lead, m.d_ff_shared or fe * m.n_shared_experts)
            out["moe"] = moe
        else:
            out["mlp"] = gated_mlp(lead, f, cfg.gated_mlp)
        return out

    spec: dict = {"embed": {"table": ("normal", (cfg.vocab, d), 0.02,
                                      ("vocab", "embed_r"))}}
    spec["segments"] = [{} if seg.kind is BlockKind.SHARED_ATTN
                        else block((seg.count,), seg.kind, cfg.enc_dec)
                        for seg in cfg.resolved_segments()]
    if cfg.shared_attn_every:
        spec["shared_block"] = block((), BlockKind.DENSE)
    spec["final_norm"] = model_norm(())
    if not cfg.tied_embeddings:
        spec["lm_head"] = {"w": ("normal", (d, cfg.vocab),
                                 1 / math.sqrt(d), ("embed_r", "vocab"))}
    if cfg.mtp:
        spec["mtp_block"] = block((), BlockKind.DENSE)
        spec["mtp_norm"] = model_norm(())
    if cfg.enc_dec:          # JAX builds the encoder with kv_heads = n_heads
        spec["encoder"] = block((cfg.n_encoder_layers,), BlockKind.DENSE,
                                hkv=hq)
        spec["enc_norm"] = model_norm(())
        kv_axes = ("embed", "kv_heads", "head_dim")
        spec["cross_k"] = dense((), d, hkv, hd, axes=kv_axes)
        spec["cross_v"] = dense((), d, hkv, hd, axes=kv_axes)
    return spec


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> dict:
    """Random weights for ``cfg``: embedding rows N(0, 0.02), projections
    N(0, 1/fan_in) as in ``init_dense``, the router (and its ``noaux_tc``
    bias) N(0, 0.02), zero biases, unit norm scales.

    ``dtype`` is the storage of every leaf but those
    :func:`serves_in_float32` keeps in float32, so ``dtype=bfloat16``
    gives the tree :func:`cast_for_serving` would make of the float32 one,
    bit for bit.  Each leaf is allocated once in its storage dtype and
    filled ``FILL_CHUNK`` values at a time from float32 draws, so the peak
    is the tree plus two float32 chunks (the draw and its scaled copy, 64
    MiB each): a full-width MoE model is built in bfloat16 without its
    float32 tree ever existing."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, path) for v in node]
        kind, shape = node[0], node[1]
        out_dtype = torch.float32 if serves_in_float32(path) else dtype
        if kind == "zeros":
            return torch.zeros(shape, device=dev, dtype=out_dtype)
        if kind == "ones":
            return torch.ones(shape, device=dev, dtype=out_dtype)
        if kind == "a_log":
            return torch.log(torch.linspace(
                1.0, 16.0, shape[-1], device=dev)).to(out_dtype).expand(
                    shape).contiguous()
        out = torch.empty(shape, device=dev, dtype=out_dtype)
        flat = out.view(-1)
        for start in range(0, flat.numel(), FILL_CHUNK):
            part = flat[start:start + FILL_CHUNK]
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * node[2])
        return out
    return build(_spec(cfg), ())


def abstract_ptree(cfg: ArchConfig, dtype: torch.dtype = torch.float32
                   ) -> dict:
    """The tree :func:`init_params` builds, as :class:`~.param.P` leaves
    of ``meta`` tensors (shapes and dtypes, no storage) with JAX's logical
    axes: the counterpart of ``jax.eval_shape(init_lm)``.  ``dtype`` is
    every leaf's, as JAX's abstract init is float32 throughout."""
    _check_supported(cfg)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return pm.abstract(node[1], node[-1], dtype)
    return build(_spec(cfg))


def cast_for_serving(params: dict, dtype: torch.dtype) -> dict:
    """Store every projection weight and bias in the serving dtype.

    The JAX ``dense`` casts its float32 weight to the activation dtype on
    every call, which XLA fuses into the matmul; an eager port would copy
    each weight once per call instead.  Casting once up front gives the
    same values.  The leaves :func:`serves_in_float32` names stay float32,
    where the JAX model computes from the float32 weight.  A leaf already
    in its dtype is kept, not copied."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return node if serves_in_float32(path) else node.to(dtype)
    return walk(params, ())
