"""Core layers of the dense GQA decoder, from :mod:`repro.models.layers`.

Same conventions as the JAX module: parameters are plain dicts of tensors
(``{"w": ..., "b": ...}``, ``{"scale": ...}``, LayerNorm's ``{"scale",
"bias"}``, ``{"table": ...}``) and the
functions are pure.  Norms and the tied read-out compute in float32 as the
JAX versions do; projections run in the activation dtype.  Under an
activation policy with DTensor inputs (the sharded steps) the
projections, the embedding and the read-out run as the sharded ops of
:mod:`repro_torch.distributed.act_sharding`, and the norms gather their
(FSDP-sharded) scales.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.act_sharding import (as_dtensor, is_sharded, replicate,
                                        sharded_dense, sharded_embed)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * replicate(params["scale"])).to(dtype)


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """JAX's LayerNorm: mean and (population) variance in float32, then
    ``y * scale + bias`` from the float32 leaves, cast back."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * replicate(params["scale"])
            + replicate(params["bias"])).to(dtype)


def dense(params: dict, x: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Projection contracting the last ``n_in`` axes of x with the first
    ``n_in`` axes of w, as one matmul of reshaped views: the JAX module's
    einsum specs 'btd,dhq->bthq', 'btd,df->btf' (``n_in=1``) and
    'bthq,hqd->btd' (``n_in=2``)."""
    if is_sharded(x):
        y = sharded_dense(params["w"], x, n_in)
        if "b" in params:
            y = y + replicate(params["b"]).to(x.dtype)
        return y
    w = params["w"].to(x.dtype)
    lead = x.shape[:x.dim() - n_in]
    y = (x.reshape(lead + (-1,)) @ w.reshape(-1, math.prod(w.shape[n_in:]))
         ).reshape(lead + w.shape[n_in:])
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def embed(params: dict, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first, without
    # converting all [vocab, d] rows on every call
    if is_sharded(params["table"]):
        return sharded_embed(params["table"], tokens, dtype)
    return params["table"][tokens].to(dtype)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied read-out: logits in float32 (the 'btd,vd->btv' einsum)."""
    if is_sharded(x):
        return sharded_dense(params["table"].float().t(), x.float(), 1)
    return x.float() @ params["table"].float().t()


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of ``positions`` [..., L] -> two [..., L, 1, D/2] tables.

    Every layer of a forward rotates by the same positions, so the forward
    computes these once and hands them to :func:`rotate`."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor: ``0.1 mscale ln(factor) + 1`` past a
    factor of 1, else 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(dim: int, theta: float, m,
               device: torch.device | None = None) -> torch.Tensor:
    """YaRN's inverse frequencies over ``dim`` rope dims for the
    ``MlaConfig`` ``m`` (DeepSeek-V3's ``rope_scaling``, as its
    ``inference/model.py`` and HF's ``DeepseekV3YarnRotaryEmbedding``
    compute them): the plain ``theta^(-2i/dim)`` blended with their
    interpolation ``/ factor`` by a linear ramp over the correction
    range ``[floor(c(beta_fast)), ceil(c(beta_slow))]``, ``c(r) = dim
    ln(original / (2 pi r)) / (2 ln theta)``: dims below it keep their
    frequency, dims above it are interpolated."""
    freqs = rope_freqs(dim, theta, device)

    def corr(rotations: float) -> float:
        return (dim * math.log(m.yarn_original_len
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(m.yarn_beta_fast)), 0)
    high = min(math.ceil(corr(m.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    return freqs / m.yarn_factor * ramp + freqs * (1 - ramp)


def mla_rope_tables(positions: torch.Tensor, m,
                    theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """MLA's rope tables over ``m.qk_rope_head_dim``: :func:`rope_tables`,
    or with YaRN (``m.yarn_factor`` > 1) at :func:`yarn_freqs`."""
    dim = m.qk_rope_head_dim
    if m.yarn_factor <= 1:
        return rope_tables(positions, dim, theta)
    angles = positions[..., None].float() * yarn_freqs(dim, theta, m,
                                                       positions.device)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x [..., L, H, D] by precomputed tables (a
    sharded x takes plain tables as replicated DTensors, so that no
    product mixes the two kinds, in the backward either)."""
    if is_sharded(x):
        cos, sin = (as_dtensor(t, x.device_mesh) for t in (cos, sin))
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., L, H, D] (D even), positions: [..., L] (int)."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return rotate(x, cos, sin)


def sinusoidal_positions(length: int, d: int,
                         device: torch.device | None = None) -> torch.Tensor:
    """[length, d] float32 table: sin at even columns and cos at odd ones
    of ``pos * exp(-2i log(10000) / d)``, every step in float32 as in
    JAX."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    rate = -torch.log(torch.tensor(10000.0, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * rate)
    pe = torch.zeros((length, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


def mlp(params: dict, x: torch.Tensor,
        act_name: str = "silu") -> torch.Tensor:
    act = activation(act_name)
    h = dense(params["wi"], x)
    if "wg" in params:
        h = act(dense(params["wg"], x)) * h
    else:
        h = act(h)
    return dense(params["wo"], h)
