"""Public dense-stripe decode-attention op, from
:mod:`repro.kernels.decode_attn.ops`.

Routing is by the tensors' device and nothing else: a CUDA query goes to
the hand-written kernel (:mod:`.kernel`), a CPU query to the plain PyTorch
version (:mod:`.ref`).  There is no fallback: a CUDA call the kernel
cannot take raises.  The JAX module's ``DecodeAttnPolicy`` (a trace-time
global carrying the routing mode, block size, tuned launch configs and the
``kv_cap`` bound) has no counterpart: the caller passes the bound as
``s_cap``.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length, *, s_cap: int | None = None) -> torch.Tensor:
    """q: [B, Hq, D] one-token queries; k/v: [B, S, Hkv, D] stripes; slot b
    attends over the first ``length[b]`` rows (a scalar length is
    broadcast; a length above the rows read masks nothing).  ``s_cap``
    bounds the rows read to the first ``s_cap``, a host-known bound on the
    deepest live slot, as the JAX op's grid pruning does.  Returns q's
    dtype."""
    s = k.shape[1]
    cap = s if s_cap is None else min(int(s_cap), s)
    if q.device.type == "cuda":
        b = q.shape[0]
        ln = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).reshape(-1)
        return kernel.decode_attn_cuda(q.contiguous(), k, v,
                                       ln.expand(b).contiguous(), cap)
    return ref.decode_attn_ref(q, k[:, :cap], v[:, :cap],
                               length).to(q.dtype)
