"""Mixture-of-Experts FFN with rank-based dispatch, from
:mod:`repro.models.moe` (``route`` and the single-device ``moe_apply``).

Routing is a float32 softmax over the experts, top-k, renormalised.  Each
expert takes a fixed capacity of ``max(1, int(T k capacity_factor / E))``
(token, choice) slots, where T counts every row and position of the call;
a slot's place in its expert is its token-major rank, and ranks past the
capacity drop.  The dispatched tokens form capacity-padded slabs [E, C, D]
whose rows at or past each expert's count are padding, and the expert
GEMMs run over them through :func:`repro_torch.kernels.moe_group_gemm.
group_gemm`, which skips the padded tiles (the paper's §5.1.2 inside the
LM).  The routing-weighted outputs are summed back per token, and the
shared experts add a gated MLP.

Nothing in a call reads a value back to the host: the capacity is known
from the shapes, the per-expert counts come from the one-hot cumsum that
also gives the ranks, and the scatters send dropped slots to a padding
slot.  The combine gathers each (token, choice) pair's expert row and sums
the k of them per token, which is the JAX scatter-add of the same terms
without atomics; the terms are summed in another order, so float32 results
agree to rounding.  Training asks ``moe_apply`` for the Switch-style
load-balance term as well (:func:`aux_load_balance_loss`, JAX's formula);
serving does not, and computes nothing for it.  Not ported (the sharding
slice): the ``shard_map`` path.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels.moe_group_gemm import group_gemm
from .layers import activation, mlp


def route(params: dict, x2d: torch.Tensor, cfg: ArchConfig):
    """x2d: [T, D] -> (weights [T, k] float32, expert ids [T, k] int64,
    router probs [T, E] float32)."""
    m = cfg.moe
    logits = x2d.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, m.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)   # renormalize
    return w, ids, probs


def aux_load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss, float32: ``E * sum(density *
    prob_mass)`` with ``density`` each expert's share of the top-k choices
    ``ids`` [T, k] and ``prob_mass`` its mean router probability over the
    T rows of ``probs`` [T, E]."""
    density = torch.nn.functional.one_hot(ids, n_experts).float().mean(
        dim=(0, 1))
    prob_mass = probs.float().mean(dim=0)
    return n_experts * torch.sum(density * prob_mass)


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for a call over ``tokens`` tokens (every row and
    padding position counts)."""
    m = cfg.moe
    return max(1, int(tokens * m.top_k * m.capacity_factor / m.n_experts))


def dispatch(ids: torch.Tensor, n_experts: int, cap: int):
    """Token-major rank dispatch of the top-k choices ``ids`` [T, k].

    Returns ``slot`` [T k] (each choice's place ``e * cap + rank``, or the
    drop slot ``E cap`` past the capacity), ``buf_tok`` [E cap] (the token
    in each place, or T for padding) and ``counts`` [E] int32 (kept places
    per expert, ``min(choices of e, cap)``)."""
    t, k = ids.shape
    flat = ids.reshape(-1)
    experts = torch.arange(n_experts, device=ids.device)
    onehot = (flat[:, None] == experts).to(torch.int32)      # [T k, E]
    cum = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    rank = cum.gather(1, flat[:, None])[:, 0] - 1
    drop = n_experts * cap
    slot = torch.where(rank < cap, flat * cap + rank,
                       torch.full_like(flat, drop))
    tok = torch.arange(t, device=ids.device)[:, None].expand(t, k).reshape(-1)
    buf_tok = torch.full((drop + 1,), t, dtype=torch.int64, device=ids.device)
    buf_tok.scatter_(0, slot, tok)      # duplicates only at the drop slot
    counts = torch.clamp(cum[-1], max=cap) if t else cum.new_zeros(n_experts)
    return slot, buf_tok[:drop], counts


def moe_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
              act_name: str = "silu", *, with_aux: bool = False):
    """x: [B, L, D] -> y [B, L, D] in x's dtype; with ``with_aux`` (the
    training loss), ``(y, aux)`` with aux :func:`aux_load_balance_loss`
    over the call's rows, as the JAX function returns."""
    m = cfg.moe
    b, length, d = x.shape
    t, e = b * length, m.n_experts
    x2d = x.reshape(t, d)
    w, ids, probs = route(params, x2d, cfg)
    cap = capacity(cfg, t)
    slot, buf_tok, counts = dispatch(ids, e, cap)

    # gather [E, C, D]; padding places read the zero row appended to x
    xpad = torch.cat([x2d, x2d.new_zeros(1, d)])
    xe = xpad[buf_tok].reshape(e, cap, d)

    # expert GEMMs: each float32 product rounds to x's dtype where the JAX
    # einsum of x-dtype operands yields x's dtype
    act = activation(act_name)
    wi, wg, wo = (params[n].to(x.dtype) for n in ("wi", "wg", "wo"))
    h = (act(group_gemm(xe, wg, counts).to(x.dtype))
         * group_gemm(xe, wi, counts).to(x.dtype))
    ye = group_gemm(h, wo, counts).to(x.dtype)                # [E, C, D]

    # weighted combine: choice j of token t reads its place's row (the
    # drop slot reads a zero row) times its routing weight
    yflat = torch.cat([ye.reshape(e * cap, d), ye.new_zeros(1, d)])
    terms = yflat[slot] * w.reshape(-1, 1).to(ye.dtype)       # [T k, D]
    y = terms.reshape(t, m.top_k, d).sum(dim=1).reshape(b, length, d)

    if "shared" in params:
        y = y + mlp(params["shared"], x, act_name)
    if with_aux:
        return y.to(x.dtype), aux_load_balance_loss(probs, ids, e)
    return y.to(x.dtype)
