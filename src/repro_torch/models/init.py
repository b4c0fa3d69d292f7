"""Seeded parameter init with the shapes and scales of
:func:`repro.models.transformer.init_lm` (dense GQA decoders).

The tree has the JAX layout, unwrapped (see ``repro.models.param.unwrap``):
layer-stacked ``segments`` whose leaves are ``[n_layers, ...]``.  Values
come from a ``torch.Generator`` seeded explicitly, so they differ from the
JAX init's; parity tests feed both packages the JAX weights through
:mod:`repro_torch.models.bridge` instead.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig, AttnKind, BlockKind
from ..device import resolve_device


def _check_supported(cfg: ArchConfig) -> None:
    kinds = {s.kind for s in cfg.resolved_segments()}
    if (kinds != {BlockKind.DENSE} or cfg.attn is not AttnKind.GQA
            or cfg.enc_dec or cfg.shared_attn_every or cfg.moe is not None
            or cfg.frontend.value != "none"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense GQA decoders only so far")


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> dict:
    """Random weights for ``cfg``: embedding rows N(0, 0.02), projections
    N(0, 1/fan_in) as in ``init_dense``, zero biases, unit norm scales."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.kv_heads
    hd, f = cfg.resolved_head_dim, cfg.d_ff

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    params: dict = {"embed": {"table": normal((cfg.vocab, d), 0.02)}}
    segments = []
    for seg in cfg.resolved_segments():
        n = seg.count
        attn = {}
        for name, heads in (("q", hq), ("k", hkv), ("v", hkv)):
            attn[name] = {"w": normal((n, d, heads, hd), 1 / math.sqrt(d))}
            if cfg.qkv_bias:
                attn[name]["b"] = zeros((n, heads, hd))
        attn["o"] = {"w": normal((n, hq, hd, d), 1 / math.sqrt(hq * hd))}
        mlp = {"wi": {"w": normal((n, d, f), 1 / math.sqrt(d))},
               "wo": {"w": normal((n, f, d), 1 / math.sqrt(f))}}
        if cfg.gated_mlp:
            mlp["wg"] = {"w": normal((n, d, f), 1 / math.sqrt(d))}
        segments.append({"norm1": {"scale": ones((n, d))}, "attn": attn,
                         "norm2": {"scale": ones((n, d))}, "mlp": mlp})
    params["segments"] = segments
    params["final_norm"] = {"scale": ones((d,))}
    if not cfg.tied_embeddings:
        params["lm_head"] = {"w": normal((d, cfg.vocab), 1 / math.sqrt(d))}
    return params


def cast_for_serving(params: dict, dtype: torch.dtype) -> dict:
    """Store every projection weight and bias in the serving dtype.

    The JAX ``dense`` casts its float32 weight to the activation dtype on
    every call, which XLA fuses into the matmul; an eager port would copy
    each weight once per call instead.  Casting once up front gives the
    same values.  Norm scales and the embedding table stay float32: the
    norms multiply in float32, the embedding gathers rows before it casts,
    and the tied read-out computes its logits in float32."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        keep = path[-1] == "scale" or path[:1] == ("embed",)
        return node if keep else node.to(dtype)
    return walk(params, ())
