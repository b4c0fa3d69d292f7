"""The plain reference: a frozen float32 decoder in plain PyTorch.

It covers the layer kinds the benchmark's configurations use: token
embedding, pre-norm RMSNorm blocks of grouped-query attention with
split-half RoPE over the whole head (and optional q/k/v biases), then a
dense MLP (gated SiLU or plain tanh-GELU) or a routed-expert layer
(float32 softmax router, top-k renormalised, gated SiLU experts, gated
SiLU shared experts; with ``capacity`` the token-major rank dispatch that
drops the choices past an expert's places), a final RMSNorm and the
read-out (an untied ``lm_head`` or the tied embedding).

It reads the weight tensors the benchmark made (the port's layout:
``segments`` of layer-stacked leaves) and works everything else out
itself: positions, RoPE tables, masks, routing.  It runs one sequence at
a time, layer by layer over all the sequences given, so only one layer's
weights are held in float32 at once.  TF32 is switched off while it
runs.  ``fp8=True`` is the control: every projection (attention, MLP,
experts) multiplies operands rounded to float8 e4m3, the activations
scaled per token and the weights per output column, as a serving path
one precision below bfloat16 would.

It imports nothing but torch.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
COVERS = {"attn": ["gqa"], "segments": ["dense", "moe"],
          "activation": ["silu", "gelu"]}


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (the reduction axis of its product), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x [..., K] @ w [K, N] in float32 (operands through fp8 with
    ``fp8``)."""
    if fp8:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


@contextlib.contextmanager
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(f"the reference has no activation {name!r}")


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotation of x [L, H, D] at positions 0 .. L-1."""
    length, _, d = x.shape
    half = d // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(length, dtype=torch.float32,
                       device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _proj(p: dict, x: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x [L, d] through a projection leaf {"w": [d, ...], "b"?}: [L, ...]."""
    w = p["w"].float()
    y = matmul(x, w.reshape(w.shape[0], -1), fp8).reshape(
        (x.shape[0],) + tuple(w.shape[1:]))
    if "b" in p:
        y = y + p["b"].float()
    return y


def attention(p: dict, x: torch.Tensor, port: dict, fp8: bool) -> torch.Tensor:
    hq, hkv = port["n_heads"], port["kv_heads"]
    q = rope(_proj(p["q"], x, fp8), port["rope_theta"])         # [L, hq, D]
    k = rope(_proj(p["k"], x, fp8), port["rope_theta"])         # [L, hkv, D]
    v = _proj(p["v"], x, fp8)
    length, _, d = q.shape
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    mask = torch.ones(length, length, dtype=torch.bool,
                      device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    wo = p["o"]["w"].float()
    return matmul(out.reshape(length, -1), wo.reshape(-1, wo.shape[-1]), fp8)


def mlp(p: dict, x: torch.Tensor, act, fp8: bool) -> torch.Tensor:
    h = _proj(p["wi"], x, fp8)
    if "wg" in p:
        h = act(_proj(p["wg"], x, fp8)) * h
    else:
        h = act(h)
    return _proj(p["wo"], h, fp8)


def moe(p: dict, x: torch.Tensor, moe_cfg: dict, act, fp8: bool,
        capacity: int | None = None) -> torch.Tensor:
    """x [T, d] through the routed experts and the shared ones.  With
    ``capacity``, a (token, choice) pair whose token-major rank among its
    expert's pairs reaches it contributes nothing."""
    k = moe_cfg["top_k"]
    probs = torch.softmax(x @ p["router"]["w"].float(), dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(ids, dtype=torch.bool)
    if capacity is not None:
        flat = ids.reshape(-1)
        onehot = F.one_hot(flat, moe_cfg["n_experts"]).to(torch.int64)
        rank = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep = (rank < capacity).reshape(ids.shape)
    y = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        tok, choice = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = (act(matmul(xe, p["wg"][e].float(), fp8))
             * matmul(xe, p["wi"][e].float(), fp8))
        ye = matmul(h, p["wo"][e].float(), fp8)
        y.index_add_(0, tok, ye * w[tok, choice][:, None])
    if "shared" in p:
        y = y + mlp(p["shared"], x, act, fp8)
    return y


def _layer(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def layers(weights: dict, port: dict):
    """(kind, layer weights) for every layer, in order."""
    for si, (kind, count) in enumerate(port["segments"]):
        for i in range(count):
            yield kind, _layer(weights["segments"][si], i)


def forward(weights: dict, port: dict, seqs: list[list[int]], *,
            score_from: list[int], fp8: bool = False,
            capacity: int | None = None, chunk: int = 256):
    """Float32 causal forwards of the token lists ``seqs``; for each, the
    logits at positions ``score_from[i]`` to the end, yielded as [n, V]
    blocks of at most ``chunk`` rows: ``(i, first position, logits)``.
    ``capacity`` (MoE places an expert) applies to each sequence's own
    call; None routes without dropping."""
    dev = weights["embed"]["table"].device
    act = _act(port["activation"])
    eps = port["norm_eps"]
    with _no_tf32(), torch.no_grad():
        xs = [weights["embed"]["table"][torch.as_tensor(s, device=dev)]
              .float() for s in seqs]
        for kind, lw in layers(weights, port):
            for j, x in enumerate(xs):
                h = attention(lw["attn"], rmsnorm(x, lw["norm1"]["scale"],
                                                 eps), port, fp8)
                x = x + h
                z = rmsnorm(x, lw["norm2"]["scale"], eps)
                if kind == "moe":
                    x = x + moe(lw["moe"], z, port["moe"], act, fp8,
                                capacity)
                else:
                    x = x + mlp(lw["mlp"], z, act, fp8)
                xs[j] = x
        if port["tied_embeddings"]:
            head = weights["embed"]["table"].float().t()
        else:
            head = weights["lm_head"]["w"].float()
        fs = weights["final_norm"]["scale"]
        for j, x in enumerate(xs):
            h = rmsnorm(x[score_from[j]:], fs, eps)
            for at in range(0, h.shape[0], chunk):
                yield j, score_from[j] + at, h[at:at + chunk] @ head
