"""The plain reference of DeepSeek-V3 (hf:deepseek-ai/DeepSeek-V3,
``inference/model.py`` and ``modeling_deepseek.py``): a frozen float32
decoder in plain PyTorch, at the chip's share of the experts.

Each layer: RMSNorm, multi-head latent attention in its published,
expanded form (q through its low-rank ``q_a``/``q_b`` pair and their
norm; the latent ``c_kv`` normed, expanded to per-head keys and values;
the rope halves of q and of the one shared rope key rotated at YaRN's
frequencies; softmax scale ``(nope + rope)^-1/2`` times ``mscale^2``;
causal), then RMSNorm and a gated SiLU MLP (the leading dense layers) or
the routed experts: the ``noaux_tc`` gate (sigmoid scores, plus the
correction bias for the choice only; a group scores the sum of its best
two; the ``topk_group`` best of ``n_group`` groups stay; top-k; the
chosen scores renormalised times ``routed_scaling``), the choices that
land on the held experts 0 .. ``experts_held`` - 1 computed and the rest
left out, as one chip of an expert-parallel layer leaves them, plus the
whole shared expert.  Nothing drops.  A final RMSNorm and the untied
read-out.

Rotation is split-half over the rope dims, as the program's; the
checkpoint's interleaved pairs are a fixed permutation of the weight
columns, which random weights do not see.  YaRN's tables are written
from HF's ``yarn_find_correction_range``, ``yarn_linear_ramp_mask`` and
``yarn_get_mscale``.

It reads the weight tensors the benchmark made (the port's layout) and
works positions, tables, masks and routing out itself, one sequence at a
time, layer by layer, one layer's weights in float32 at once, queries in
blocks, TF32 off.  ``fp8=True`` is the control: every projection's
operands rounded through float8 e4m3 (``model.matmul``).

It imports nothing but torch and the plain reference beside it.
"""
from __future__ import annotations

import importlib.util
import math
import pathlib

import torch


def _sibling(name: str):
    """The module ``<name>.py`` beside this one, loaded by file as the
    harness loads a reference."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_reference_{name}", pathlib.Path(__file__).with_name(
            f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_base = _sibling("model")     # its RMSNorm, projections, MLP and control

COVERS = {"attn": ["mla"], "segments": ["dense", "moe"],
          "activation": ["silu"]}
Q_BLOCK = 512            # query rows a block of attention scores


def _mscale(factor: float, mscale: float) -> float:
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def yarn_tables(length: int, mla: dict, theta: float, device):
    """cos, sin [L, 1, rope/2] of positions 0 .. L-1 at YaRN's
    frequencies (plain RoPE where ``yarn_factor`` is 1 or absent).  HF
    multiplies both by ``mscale(factor, mscale) / mscale(factor,
    mscale_all_dim)``, 1 for DeepSeek-V3 (both 1)."""
    dim = mla["qk_rope_head_dim"]
    factor = float(mla.get("yarn_factor", 1.0))
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / theta ** exps
    inv = extra
    if factor > 1:
        inter = 1.0 / (factor * theta ** exps)
        orig = mla["yarn_original_len"]

        def corr_dim(rot):
            return (dim * math.log(orig / (rot * 2 * math.pi))
                    / (2 * math.log(theta)))
        low = max(math.floor(corr_dim(mla["yarn_beta_fast"])), 0)
        high = min(math.ceil(corr_dim(mla["yarn_beta_slow"])), dim - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
                 - low) / (high - low)).clamp(0, 1)
        mask = 1.0 - ramp
        inv = inter * (1 - mask) + extra * mask
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv
    return torch.cos(ang)[:, None], torch.sin(ang)[:, None]


def softmax_scale(mla: dict) -> float:
    scale = (mla["qk_nope_head_dim"] + mla["qk_rope_head_dim"]) ** -0.5
    all_dim = mla.get("yarn_mscale_all_dim", 0.0)
    if all_dim:
        scale *= _mscale(float(mla["yarn_factor"]), all_dim) ** 2
    return scale


def _rotate(x: torch.Tensor, cos, sin) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: dict, x: torch.Tensor, port: dict, tables,
              fp8: bool) -> torch.Tensor:
    """x [L, d] through MLA, expanded: [L, d]."""
    mla, eps = port["mla"], port["norm_eps"]
    nope = mla["qk_nope_head_dim"]
    length = x.shape[0]
    if mla.get("q_lora_rank"):
        cq = _base.rmsnorm(_base._proj(p["dq"], x, fp8),
                           p["dq_norm"]["scale"], eps)
        q = _base._proj(p["uq"], cq, fp8)                 # [L, H, nope+rope]
    else:
        q = _base._proj(p["q"], x, fp8)
    q_nope, q_pe = q[..., :nope], _rotate(q[..., nope:], *tables)
    c = _base.rmsnorm(_base._proj(p["dkv"], x, fp8), p["dkv_norm"]["scale"],
                      eps)                                # [L, r]
    k_pe = _rotate(_base._proj(p["kr"], x, fp8)[:, None], *tables)[:, 0]
    k_nope = _base._proj(p["uk"], c, fp8)                 # [L, H, nope]
    v = _base._proj(p["uv"], c, fp8)                      # [L, H, v]
    scale = softmax_scale(mla)
    out = torch.empty(v.shape, dtype=torch.float32, device=x.device)
    for q0 in range(0, length, Q_BLOCK):
        q1 = min(length, q0 + Q_BLOCK)
        s = (torch.einsum("qhd,khd->hqk", q_nope[q0:q1], k_nope[:q1])
             + torch.einsum("qhd,kd->hqk", q_pe[q0:q1], k_pe[:q1])) * scale
        mask = (torch.arange(q1, device=x.device)[None, :]
                <= torch.arange(q0, q1, device=x.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:q1])
    wo = p["o"]["w"].float()
    return _base.matmul(out.reshape(length, -1),
                        wo.reshape(-1, wo.shape[-1]), fp8)


def gate(p: dict, x: torch.Tensor, moe: dict):
    """The ``noaux_tc`` gate of x [T, d]: (weights [T, k], ids [T, k])."""
    t = x.shape[0]
    e, k = moe["n_experts"], moe["top_k"]
    scores = torch.sigmoid(x @ p["router"]["w"].float())
    choice = scores + p["router"]["bias"].float()
    groups = moe.get("n_group", 1)
    if groups > 1:
        per = choice.reshape(t, groups, e // groups)
        group_score = per.topk(min(2, e // groups), dim=-1)[0].sum(-1)
        best = group_score.topk(moe["topk_group"], dim=-1)[1]
        drop = torch.ones(t, groups, dtype=torch.bool,
                          device=x.device).scatter_(1, best, False)
        choice = per.masked_fill(drop[..., None], float("-inf")).reshape(t, e)
    ids = choice.topk(k, dim=-1)[1]
    w = scores.gather(1, ids)
    return w / w.sum(-1, keepdim=True) * moe["routed_scaling"], ids


def moe_layer(p: dict, x: torch.Tensor, moe: dict, fp8: bool) -> torch.Tensor:
    """x [T, d] through the held experts' part and the shared expert."""
    act = _base._act("silu")
    w, ids = gate(p, x, moe)
    held = moe.get("experts_held") or moe["n_experts"]
    y = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        if e >= held:
            continue                  # another chip's expert
        tok, choice = torch.nonzero(ids == e, as_tuple=True)
        xe = x[tok]
        h = (act(_base.matmul(xe, p["wg"][e].float(), fp8))
             * _base.matmul(xe, p["wi"][e].float(), fp8))
        y.index_add_(0, tok, _base.matmul(h, p["wo"][e].float(), fp8)
                     * w[tok, choice][:, None])
    if "shared" in p:
        y = y + _base.mlp(p["shared"], x, act, fp8)
    return y


def forward(weights: dict, port: dict, seqs: list[list[int]], *,
            score_from: list[int], fp8: bool = False, chunk: int = 256):
    """Float32 causal forwards of the token lists ``seqs``; for each, the
    logits at positions ``score_from[i]`` to the end, yielded as [n, V]
    blocks of at most ``chunk`` rows: ``(i, first position, logits)``."""
    dev = weights["embed"]["table"].device
    eps = port["norm_eps"]
    act = _base._act(port["activation"])
    with _base._no_tf32(), torch.no_grad():
        xs = [weights["embed"]["table"][torch.as_tensor(s, device=dev)]
              .float() for s in seqs]
        tables = [yarn_tables(len(s), port["mla"], port["rope_theta"], dev)
                  for s in seqs]
        for kind, lw in _base.layers(weights, port):
            for j, x in enumerate(xs):
                x = x + attention(lw["attn"], _base.rmsnorm(
                    x, lw["norm1"]["scale"], eps), port, tables[j], fp8)
                z = _base.rmsnorm(x, lw["norm2"]["scale"], eps)
                if kind == "moe":
                    x = x + moe_layer(lw["moe"], z, port["moe"], fp8)
                else:
                    x = x + _base.mlp(lw["mlp"], z, act, fp8)
                xs[j] = x
        head = weights["lm_head"]["w"].float()
        fs = weights["final_norm"]["scale"]
        for j, x in enumerate(xs):
            h = _base.rmsnorm(x[score_from[j]:], fs, eps)
            for at in range(0, h.shape[0], chunk):
                yield j, score_from[j] + at, h[at:at + chunk] @ head
