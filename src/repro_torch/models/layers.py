"""Core layers of the dense GQA decoder, from :mod:`repro.models.layers`.

Same conventions as the JAX module: parameters are plain dicts of tensors
(``{"w": ..., "b": ...}``, ``{"scale": ...}``, ``{"table": ...}``) and the
functions are pure.  Norms and the tied read-out compute in float32 as the
JAX versions do; projections run in the activation dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dtype)


def dense(params: dict, x: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Projection contracting the last ``n_in`` axes of x with the first
    ``n_in`` axes of w, as one matmul of reshaped views: the JAX module's
    einsum specs 'btd,dhq->bthq', 'btd,df->btf' (``n_in=1``) and
    'bthq,hqd->btd' (``n_in=2``)."""
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
    return params["table"][tokens].to(dtype)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied read-out: logits in float32 (the 'btd,vd->btv' einsum)."""
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


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x [..., L, H, D] by precomputed tables."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., L, H, D] (D even), positions: [..., L] (int)."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return rotate(x, cos, sin)


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
