"""Plain PyTorch version of the dense-stripe decode attention, from
:mod:`repro.kernels.decode_attn.ref`: the CPU path of :func:`.ops.
decode_attn` and the version the CUDA kernel is held against on the card.

It computes what the TPU kernel (``decode_attn_kernel``) computes, which
differs from the JAX ``decode_attn_ref`` at one edge: a slot of length 0
gives zeros (the kernel's ``acc / max(l, 1e-30)`` over no live key), not
the uniform average over every masked row that a softmax of all -1e30
scores would give."""
from __future__ import annotations

import math

import torch


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    length) -> torch.Tensor:
    """q: [B, Hq, D]; k/v: [B, S, Hkv, D]; slot b attends over
    ``k[b, :length[b]]`` (a scalar length is broadcast; a length above S
    masks nothing).  Softmax in float32 with masked scores at -1e30.
    Returns [B, Hq, D] float32."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(d)
    ln = torch.as_tensor(length, dtype=torch.int64,
                         device=q.device).reshape(-1).expand(b)
    live = (torch.arange(s, device=q.device)[None, :]
            < ln[:, None])[:, None, None, :]                  # [B,1,1,S]
    scores = torch.where(live, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(b, hq, d)
