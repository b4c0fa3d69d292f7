"""Mamba-2 SSD (state-space duality) blocks, from :mod:`repro.models.ssm`
(arXiv:2405.21060).

A prefill runs the chunked SSD: the JAX ``lax.scan`` over chunks becomes
a Python loop that carries the float32 inter-chunk state, with the
intra-chunk terms as einsums.  A one-token call over a cache is the
linear recurrence on the ``[B, H, P, N]`` float32 state.  Block layout:
in-projections (z, xBC, dt); a causal depthwise conv and silu on xBC
(decode: the rolled window of the last ``d_conv - 1`` inputs); SSD; the
``d_skip`` term; a gated RMSNorm (``y * silu(z)``); the out-projection.
No hand-written kernel: JAX computes all of it outside Pallas, as the port
does with PyTorch ops.  The casts are JAX's, so a bfloat16 run rounds
where JAX's does: ``dt`` and ``-exp(a_log)`` in float32, the segment-sum
decay matrix in the activation dtype, the state in float32.

The cache is ``{"conv": [B, d_conv - 1, d_xbc], "state": [B, H, P, N]}``
(JAX's ``SsmCache``: the conv window in the activation dtype, the state
in float32), written in place, so a CUDA graph captured over it reads the
new values.  Two departures from JAX, both for serving, where prompts of
mixed length share one right-padded prefill:

- ``lengths`` ([B]) stops each row's recurrence at its own prompt length:
  ``dt`` is zero at ``t >= lengths[b]``, so the decay there is exp(0) = 1
  and the input term 0, and the state passes through the padding
  unchanged (exactly, in any dtype).  The conv window is taken at each
  row's own end, zero-filled on the left for a prompt shorter than it.
  JAX runs the recurrence and the window through the padding.
- A multi-token call starts from a zero state and a zero window, whatever
  the cache holds (JAX starts from the cache's state): a prefill is a
  fresh start, and the serving paths never continue an SSM state with
  more than one token at a time (the batcher refuses suffix prefill,
  chunks and speculation for these models, as JAX's does).

With every row at the call's full length and a zero cache, both are JAX's
arithmetic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed.act_sharding import is_sharded, local_region
from .layers import dense, rmsnorm


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(d_inner, heads, d_xbc) of a block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_xbc = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, d_xbc


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., L] -> lower-triangular pairwise sums s[i, j] = sum(a[j+1..i])
    (-inf above the diagonal)."""
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    n = a.shape[-1]
    mask = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(xdt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None):
    """Chunked SSD.  xdt: [B, L, H, P] (inputs pre-scaled by dt), a: [B, L,
    H] (= dt * A, at most 0), b/c: [B, L, G, N].  Returns (y [B, L, H, P]
    in xdt's dtype, final state [B, H, P, N] float32)."""
    bsz, l, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    nc = -(-l // chunk)
    pad = nc * chunk - l
    if pad:      # zero inputs and decay exp(0): the state passes unchanged
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=xdt.device)
             if initial_state is None else initial_state.float())
    ys = []
    for k in range(nc):
        part = slice(k * chunk, (k + 1) * chunk)
        xk, bk, ck = xdt[:, part], b[:, part], c[:, part]
        ak = a[:, part].float()
        a_cs = torch.cumsum(ak, dim=1)                          # [B,cl,H]
        lmat = torch.exp(_segsum(ak.transpose(1, 2))).to(xk.dtype)
        # group -> head expansion via reshape (no materialised repeat)
        lh = lmat.reshape(bsz, g, hg, chunk, chunk)
        xh = xk.reshape(bsz, chunk, g, hg, p)
        # intra-chunk
        scores = torch.einsum("blgn,bsgn->bgls", ck, bk)         # [B,G,cl,cl]
        y_diag = torch.einsum("bghls,bsghp->blghp",
                              scores[:, :, None] * lh, xh)
        # the incoming state's contribution
        decay_out = torch.exp(a_cs).to(xk.dtype)                 # [B,cl,H]
        sh = state.to(xk.dtype).reshape(bsz, g, hg, p, n)
        y_off = torch.einsum("blgn,bghpn->blghp", ck, sh)
        y_off = y_off * decay_out.reshape(bsz, chunk, g, hg)[..., None]
        ys.append((y_diag + y_off).reshape(bsz, chunk, h, p))
        # state update, in float32 (JAX promotes the mixed product)
        decay_total = torch.exp(a_cs[:, -1, :])                  # [B,H]
        decay_in = torch.exp(a_cs[:, -1:, :] - a_cs)             # [B,cl,H]
        contrib = torch.einsum(
            "bsgn,bsghp->bghpn", bk.float(),
            xh * decay_in.reshape(bsz, chunk, g, hg)[..., None])
        state = (state * decay_total[:, :, None, None]
                 + contrib.reshape(bsz, h, p, n).float())
    y = torch.cat(ys, dim=1)[:, :l]
    return y, state


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             a_neg: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """One-token recurrence.  state [B, H, P, N] float32, x [B, H, P], dt
    [B, H] float32, a_neg [H], b/c [B, G, N].  Returns (new state in the
    state's dtype, y [B, H, P] in x's dtype)."""
    bsz, h, p, n = state.shape
    g = b.shape[1]
    hg = h // g
    da = torch.exp(dt * a_neg[None, :])                          # [B,H]
    xdt = x * dt[..., None]                                      # float32
    bh = b[:, :, None, :].expand(bsz, g, hg, n).reshape(bsz, h, n)
    ch = c[:, :, None, :].expand(bsz, g, hg, n).reshape(bsz, h, n)
    new_state = (state * da[:, :, None, None]
                 + xdt[..., None] * bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch.to(new_state.dtype))
    return new_state.to(state.dtype), y.to(x.dtype)


def _conv_train(params: dict, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over [B, L, C]: JAX's grouped
    ``conv_general_dilated`` is a cross-correlation, as ``F.conv1d`` is, so
    the ``[k, C]`` weight becomes ``[C, 1, k]`` unflipped."""
    k = params["conv_w"].shape[0]
    w = params["conv_w"].to(xbc.dtype).t()[:, None, :]
    out = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), w,
                   groups=xbc.shape[-1]).transpose(1, 2)
    return out + params["conv_b"].to(xbc.dtype)


def _conv_tail(xbc: torch.Tensor, k: int, lengths) -> torch.Tensor:
    """The last ``k - 1`` inputs before each row's end ([B, k-1, C]):
    ``xbc[b, lengths[b] - k + 1 : lengths[b]]``, zero-filled on the left
    where a row is shorter (JAX's tail of the whole call when ``lengths``
    is None)."""
    bsz, l, _ = xbc.shape
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    if lengths is None:
        return padded[:, l:]
    rows = torch.arange(bsz, device=xbc.device)[:, None]
    cols = (lengths.to(torch.int64).clamp(0, l)[:, None]
            + torch.arange(k - 1, device=xbc.device)[None, :])
    return padded[rows, cols]


def ssm_apply(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
              cache: dict | None = None, lengths=None) -> torch.Tensor:
    """x: [B, L, D] -> y [B, L, D]; ``cache`` (a layer's ``{"conv",
    "state"}``, see :func:`init_cache`) is written in place.

    - L = 1 with a cache: decode, continuing the cache's window and state.
    - Otherwise a prefill from a zero state and window (the cache, if
      given, takes the final ones).  ``lengths`` ([B], at most L) ends
      each row's recurrence and window at its own length; None: at L.
      Outputs past a row's length are not meaningful."""
    if is_sharded(x):
        # the block runs on the batch shard, its weights and the heads of
        # its state gathered (JAX shards the SSD's heads over model)
        return local_region(
            lambda p, xl, c, ln: ssm_apply(p, xl, cfg, cache=c, lengths=ln),
            x, params=params, state=cache, args=(lengths,))
    s = cfg.ssm
    d_inner, h, _ = _dims(cfg)
    bsz, l, _ = x.shape
    z = dense(params["in_z"], x)
    xbc = dense(params["in_xbc"], x)
    dt_raw = dense(params["in_dt"], x)
    decode = cache is not None and l == 1
    if decode:      # roll the conv window
        window = torch.cat([cache["conv"], xbc], dim=1)          # [B,k,C]
        conv_out = (torch.einsum("bkc,kc->bc", window,
                                 params["conv_w"].to(x.dtype))[:, None, :]
                    + params["conv_b"].to(x.dtype))
        cache["conv"].copy_(window[:, 1:])
    else:
        conv_out = _conv_train(params, xbc)
        if cache is not None:
            cache["conv"].copy_(_conv_tail(xbc, s.d_conv, lengths))
    xbc_act = F.silu(conv_out)
    gn = s.n_groups * s.d_state
    x_ssm = xbc_act[..., :d_inner].reshape(bsz, l, h, s.head_dim)
    bmat = xbc_act[..., d_inner:d_inner + gn].reshape(bsz, l, s.n_groups,
                                                       s.d_state)
    cmat = xbc_act[..., d_inner + gn:].reshape(bsz, l, s.n_groups,
                                               s.d_state)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a_neg = -torch.exp(params["a_log"].float())
    if decode:
        new_state, y = ssd_step(cache["state"], x_ssm[:, 0], dt[:, 0],
                                a_neg, bmat[:, 0], cmat[:, 0])
        cache["state"].copy_(new_state)
        y = y[:, None]
    else:
        if lengths is not None:   # the state passes through the padding
            live = (torch.arange(l, device=x.device)[None, :]
                    < lengths.to(torch.int64)[:, None])
            dt = torch.where(live[..., None], dt, 0.0)
        xdt = x_ssm * dt[..., None].to(x_ssm.dtype)
        y, final = ssd_chunked(xdt, dt * a_neg[None, None, :], bmat, cmat,
                               s.chunk)
        if cache is not None:
            cache["state"].copy_(final)
    y = y + x_ssm * params["d_skip"].to(y.dtype)[None, None, :, None]
    y = rmsnorm(params["norm"], y.reshape(bsz, l, d_inner) * F.silu(z),
                cfg.norm_eps)
    return dense(params["out"], y)


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    """JAX's ``init_cache``: ``{"conv": [B, d_conv - 1, d_xbc]`` in
    ``dtype``, ``"state": [B, H, P, N]`` float32``}``, zeros."""
    s = cfg.ssm
    _, h, d_xbc = _dims(cfg)
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_xbc), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, h, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device)}
