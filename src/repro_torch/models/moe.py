"""Mixture-of-Experts FFN with rank-based dispatch, from
:mod:`repro.models.moe` (``route`` and the single-device ``moe_apply``).

Routing is a float32 softmax over the experts, top-k, renormalised, or
DeepSeek-V3's ``noaux_tc`` gate (sigmoid scores, a correction bias, a
group limit, scaled weights; :func:`_route_noaux_tc`).  A config that
holds a share of the experts (``MoeConfig.experts_held``, one chip's part
of an expert-parallel layer) routes over all of them and computes the
held experts' part of the routed sum, the others' choices dropped as on
an expert-parallel rank, with no stand-in for the rest.  Each
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
serving does not, and computes nothing for it.

Under an activation policy with a DTensor input (the sharded steps) the
experts are split over the ``model`` mesh dim (expert parallelism):
:func:`_moe_shard_map`, JAX's ``shard_map`` path, taken under its
condition (a policy with a ``model`` axis, at least 4,096 tokens, the
experts dividing ``model``), dispatches each rank's own tokens to its
own experts, runs ``group_gemm`` on local, plain tensors and adds across
ranks with one all-reduce a layer.  Below 4,096 tokens JAX keeps the
global dispatch; the port computes the same function expert-parallel
over the gathered tokens, whose capacity and ranks are the global ones.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from ..distributed.act_sharding import (batch_sharded, coordinate,
                                        from_local,
                                        is_sharded, to_local)
from ..distributed.sharding import axis_sizes
from ..kernels.moe_group_gemm import group_gemm
from ..parthook import count, part
from .layers import activation, mlp


def route(params: dict, x2d: torch.Tensor, cfg: ArchConfig):
    """x2d: [T, D] -> (weights [T, k] float32, expert ids [T, k] int64,
    router probs [T, E] float32), by the config's router."""
    m = cfg.moe
    logits = x2d.float() @ params["router"]["w"].float()
    if m.router == "noaux_tc":
        return _route_noaux_tc(params["router"]["bias"], logits, m)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, m.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)   # renormalize
    return w, ids, probs


def _route_noaux_tc(bias: torch.Tensor, logits: torch.Tensor, m):
    """DeepSeek-V3's gate (``inference/model.py`` ``Gate``), in float32:
    sigmoid scores s [T, E]; the choice reads s + bias; a group's score is
    the sum of its best two (its best one in groups of one), and the
    experts outside the ``topk_group`` best of ``n_group`` groups are
    masked at -inf; ids are the top-k of what is left, and the weights
    the chosen s renormalised times ``routed_scaling``.  The sigmoid
    scores stand for the router probs."""
    t, e = logits.shape
    scores = torch.sigmoid(logits)
    biased = scores + bias.float()
    if m.n_group > 1:
        grouped = biased.reshape(t, m.n_group, e // m.n_group)
        best = torch.topk(grouped, min(2, e // m.n_group), dim=-1)[0]
        keep = torch.topk(best.sum(-1), m.topk_group, dim=-1)[1]
        mask = torch.ones((t, m.n_group), dtype=torch.bool,
                          device=logits.device).scatter_(1, keep, False)
        biased = grouped.masked_fill(mask[..., None],
                                     float("-inf")).reshape(t, e)
    ids = torch.topk(biased, m.top_k, dim=-1)[1]
    w = scores.gather(1, ids)
    w = w / w.sum(-1, keepdim=True) * m.routed_scaling
    return w, ids, scores


def held_experts(cfg: ArchConfig) -> int:
    """The experts whose slabs this chip holds (experts 0 .. n - 1)."""
    m = cfg.moe
    return m.experts_held if 0 < m.experts_held < m.n_experts \
        else m.n_experts


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


def dispatch(ids: torch.Tensor, n_experts: int, cap: int,
             mine: torch.Tensor | None = None):
    """Token-major rank dispatch of the top-k choices ``ids`` [T, k].

    Returns ``slot`` [T k] (each choice's place ``e * cap + rank``, or the
    drop slot ``E cap`` past the capacity), ``buf_tok`` [E cap] (the token
    in each place, or T for padding) and ``counts`` [E] int32 (kept places
    per expert, ``min(choices of e, cap)``).  ``mine`` ([T, k] bool, an
    expert-parallel rank's choices of its own experts, ``ids`` relative to
    its first) drops every other choice without taking a place."""
    t, k = ids.shape
    flat = ids.reshape(-1)
    experts = torch.arange(n_experts, device=ids.device)
    onehot = flat[:, None] == experts                        # [T k, E]
    if mine is not None:
        mine = mine.reshape(-1)
        onehot = onehot & mine[:, None]
        flat = flat.clamp(0, n_experts - 1)
    cum = torch.cumsum(onehot.to(torch.int32), dim=0, dtype=torch.int32)
    rank = cum.gather(1, flat[:, None])[:, 0] - 1
    drop = n_experts * cap
    keep = rank < cap if mine is None else (rank < cap) & mine
    slot = torch.where(keep, flat * cap + rank,
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
    if is_sharded(x):
        mesh = x.device_mesh
        sizes = axis_sizes(mesh)
        if ("model" in sizes and x.shape[0] * x.shape[1] >= 4096
                and cfg.moe.n_experts % sizes["model"] == 0):
            return _moe_shard_map(params, x, cfg, act_name, mesh,
                                  with_aux=with_aux)
        return _moe_shard_map(params, x, cfg, act_name, mesh,
                              with_aux=with_aux, local_tokens=False)
    m = cfg.moe
    b, length, d = x.shape
    t, e = b * length, m.n_experts
    x2d = x.reshape(t, d)
    held = held_experts(cfg)
    with part("moe.route"):
        w, ids, probs = route(params, x2d, cfg)
    if held < e:
        count("moe.held_choice", lambda: ((ids < held).sum(), ids.numel()))
    wi, wg, wo = (params[n].to(x.dtype) for n in ("wi", "wg", "wo"))
    # a share of the experts: the held slabs' part of the routed sum
    y = _experts(x2d, w, ids, wi, wg, wo, capacity(cfg, t),
                 activation(act_name), 0 if held < e else None
                 ).reshape(b, length, d)
    if "shared" in params:
        with part("moe.shared"):
            shared = mlp(params["shared"], x, act_name)
        y = y + shared
    if with_aux:
        return y.to(x.dtype), aux_load_balance_loss(probs, ids, e)
    return y.to(x.dtype)


def _experts(x2d: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
             wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor, cap: int,
             act, e_lo: int | None = None) -> torch.Tensor:
    """The routed experts of ``x2d`` [T, D] (routing weights ``w`` and
    expert ids ``ids`` [T, k]) through the slabs ``wi``/``wg`` [E', D, F]
    and ``wo`` [E', F, D] at ``cap`` places an expert: [T, D] in x's
    dtype.  ``e_lo`` (expert parallelism): the slabs are experts
    ``e_lo .. e_lo + E' - 1``, every other choice is dropped, and the
    result is this rank's partial sum."""
    t, d = x2d.shape
    e, k = wi.shape[0], ids.shape[1]
    with part("moe.dispatch"):
        if e_lo is None:
            slot, buf_tok, counts = dispatch(ids, e, cap)
        else:
            rel = ids - e_lo
            slot, buf_tok, counts = dispatch(rel, e, cap,
                                             (rel >= 0) & (rel < e))

    with part("moe.experts"):
        # gather [E, C, D]; padding places read the zero row appended to x
        xpad = torch.cat([x2d, x2d.new_zeros(1, d)])
        xe = xpad[buf_tok].reshape(e, cap, d)

        # expert GEMMs: each float32 product rounds to x's dtype where the
        # JAX einsum of x-dtype operands yields x's dtype
        h = (act(group_gemm(xe, wg, counts).to(x2d.dtype))
             * group_gemm(xe, wi, counts).to(x2d.dtype))
        ye = group_gemm(h, wo, counts).to(x2d.dtype)          # [E, C, D]

    with part("moe.combine"):
        # weighted combine: choice j of token t reads its place's row (the
        # drop slot reads a zero row) times its routing weight
        yflat = torch.cat([ye.reshape(e * cap, d), ye.new_zeros(1, d)])
        terms = yflat[slot] * w.reshape(-1, 1).to(ye.dtype)   # [T k, D]
        return terms.reshape(t, k, d).sum(dim=1)


def _moe_shard_map(params: dict, x, cfg: ArchConfig, act_name: str, mesh,
                   *, with_aux: bool = False, local_tokens: bool = True):
    """Expert-parallel MoE on a DTensor ``x`` [B, L, D], JAX's
    ``shard_map`` path: each ``model`` rank keeps its experts' slabs
    (their ``data`` shards gathered), dispatches the tokens it holds to
    them (local selection, no data movement), runs :func:`_experts` on
    local tensors and the partial outputs are summed with one all-reduce.
    ``local_tokens``: a rank's tokens are its batch shard, the capacity
    counted from them, as in JAX; otherwise every rank takes all the
    tokens and the capacity of the global dispatch (the port's form of
    JAX's global path).  Experts that do not divide ``model`` are kept
    whole on every rank.  The router's gradient, and the slabs', are
    partial over the batch shards; x's over the expert split."""
    from torch.distributed.tensor import Partial, Replicate
    m = cfg.moe
    b, length, d = x.shape
    e = m.n_experts
    n_model = axis_sizes(mesh).get("model", 1)
    split = n_model > 1 and e % n_model == 0
    keep = batch_sharded(x) if local_tokens else ()
    xl, x_pl = to_local(x, keep=keep, partial=("model",) if split else ())
    t = xl.shape[0] * length
    x2d = xl.reshape(t, d)
    if held_experts(cfg) < e:
        raise NotImplementedError("a chip's share of the experts is a "
                                  "one-chip layer; the mesh splits them")
    router = {k: to_local(v, partial=keep)[0]
              for k, v in params["router"].items()}
    w, ids, probs = route({"router": router}, x2d, cfg)
    slabs = [to_local(params[n].to(x.dtype),
                      keep=("model",) if split else (), partial=keep)[0]
             for n in ("wi", "wg", "wo")]
    e_lo = coordinate(mesh, "model") * (e // n_model) if split else None
    y2d = _experts(x2d, w, ids, *slabs, capacity(cfg, t),
                   activation(act_name), e_lo)
    names = mesh.mesh_dim_names
    y_pl = [Partial() if split and n == "model" else p
            for n, p in zip(names, x_pl)]
    y = from_local(y2d.reshape(xl.shape), mesh, y_pl).redistribute(
        mesh, x.placements)
    if "shared" in params:
        y = y + mlp(params["shared"], x, act_name)
    if not with_aux:
        return y
    n_ranks = math.prod(axis_sizes(mesh)[n] for n in keep)
    stats_pl = [Partial() if n in keep else Replicate() for n in names]
    density = from_local(torch.nn.functional.one_hot(ids, e).float().mean(
        dim=(0, 1)) / n_ranks, mesh, stats_pl)
    mass = from_local(probs.mean(dim=0) / n_ranks, mesh, stats_pl)
    rep = [Replicate()] * mesh.ndim
    aux = e * torch.sum(density.redistribute(mesh, rep)
                        * mass.redistribute(mesh, rep))
    return y, aux
