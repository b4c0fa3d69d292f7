"""Public paged-attention ops, from :mod:`repro.kernels.paged_attn.ops`.

Routing follows the active :class:`~repro_torch.kernels.decode_attn.ops.
DecodeAttnPolicy`: in mode ``"auto"`` a CUDA query goes to the
hand-written kernel (:mod:`.kernel`) and a CPU query to the plain PyTorch
version (:mod:`.ref`); mode ``"kernel"`` raises on a CPU query, and mode
``"plain"`` gathers and then attends in plain PyTorch on either device.
There is no fallback: a CUDA call the kernel cannot take raises.

On the kernel route the launch knobs (decode: ``ctas_per_sm`` and
``cta_rows``; prefill and verify: ``block_rows``) resolve through the
policy's tuned-launch cache (:mod:`.autotune`) for this call's geometry
when the caller leaves them None; explicit values always win (the
autotuner sweeps through them), and a miss keeps the kernels' defaults.

The public layout is the JAX one: q is [B, Hq, D] for decode and
[B, L, Hq, D] for prefill and verify.  The pools are read in their own
dtype; unlike the JAX ops, nothing casts the whole pool to the query dtype
on each call (eager PyTorch would copy it once per layer per step).

Sentinel handling: unallocated table entries are ``>= n_pages``.  For
reads they are clamped to a valid page here, once, and masked by the
lengths.

Telemetry (:class:`PagedAttnTelemetry`, off by default) records each op
under ``(op, route)``, route ``kernel`` or ``plain`` (JAX's ``xla``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import kernel, ref, split


class PagedAttnTelemetry:
    """Host-side timing hooks for the paged-attention ops.

    Disabled by default, in which case every op takes a single
    ``if not enabled`` branch and nothing else: no timing, no device
    sync, no allocation.  When enabled, each public op records under a
    ``(op, route)`` key (op in ``decode`` / ``prefill`` / ``verify``,
    route in ``kernel`` / ``plain``):

    * ``calls``: total invocations;
    * ``traced_calls``: the subset made while a CUDA graph is being
      captured, where the op runs once per *capture*, not per step, and
      wall time would be capture time, so those calls are counted but
      never timed or synced.  A replay never passes through Python, so
      replays are not counted at all (as JAX counts eager calls and
      traces, not executions of a compiled step);
    * ``tokens``: query-token volume (B x Lq), from the shapes, so it is
      meaningful for captured calls too;
    * ``wall_s``: eager-call wall time, measured between device syncs
      around the op.  Only eager calls pay them.

    Roofline accounting rides on the same hooks: each call also adds
    analytic traffic estimates from its shapes plus its page table and
    length metadata read to the host (eager calls; under capture the
    device-side lengths are not read and the whole sliced table is
    assumed live):

    * ``bytes``: device-memory traffic: live K/V pages touched (dead
      pages the kernels' page walk skips are subtracted) x page extent x
      dtype width x 2, plus Q read + O write + table reads;
    * ``flops``: attention math, 4 x Hq x D per causally-visible
      (query, kv) pair;
    * ``onchip_bytes``: logical K/V reads served by on-chip reuse (GQA
      group folding, query rows sharing a page) rather than device memory;
    * ``timed_bytes``: the ``bytes`` of eager (timed) calls only, so
      ``achieved_gbps`` divides matched numerator and denominator.

    ``snapshot()`` derives ``achieved_gbps`` (timed bytes over eager wall
    time) and ``op_byte`` (flops over physical + on-chip bytes, the
    :class:`~repro_torch.core.amenability.PrimitiveProfile` convention)
    per ``(op, route)``; :func:`amenability_reports` feeds the aggregates
    through the paper's amenability test.
    """

    def __init__(self):
        self.enabled = False
        self.stats: dict = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.stats = {}

    def _bump(self, op: str, route: str, tokens: int, *,
              traced: bool = False, wall: float = 0.0,
              mem_bytes: float = 0.0, flops: float = 0.0,
              onchip_bytes: float = 0.0) -> None:
        d = self.stats.setdefault((op, route), {
            "calls": 0, "traced_calls": 0, "tokens": 0, "wall_s": 0.0,
            "bytes": 0.0, "flops": 0.0, "onchip_bytes": 0.0,
            "timed_bytes": 0.0})
        d["calls"] += 1
        d["traced_calls"] += int(traced)
        d["tokens"] += tokens
        d["wall_s"] += wall
        d["bytes"] += mem_bytes
        d["flops"] += flops
        d["onchip_bytes"] += onchip_bytes
        if not traced:
            d["timed_bytes"] += mem_bytes

    def snapshot(self) -> dict:
        """Flat ``{"op.route": {...}}`` copy for reporting, with the
        derived roofline numbers: ``achieved_gbps`` (eager-call bytes
        over eager-call wall, 0 when nothing was timed) and ``op_byte``
        (flops over physical + on-chip bytes)."""
        out: dict = {}
        for (op, route), d in sorted(self.stats.items()):
            row = dict(d)
            row["achieved_gbps"] = (
                row["timed_bytes"] / row["wall_s"] / 1e9
                if row["wall_s"] > 0.0 else 0.0)
            denom = row["bytes"] + row["onchip_bytes"]
            row["op_byte"] = row["flops"] / denom if denom else 0.0
            out[f"{op}.{route}"] = row
        return out


_TELEMETRY = PagedAttnTelemetry()


def attn_telemetry() -> PagedAttnTelemetry:
    """The module-level :class:`PagedAttnTelemetry` instance shared by
    every op in this module."""
    return _TELEMETRY


def amenability_reports(pim=None, gpu=None) -> dict:
    """Run the paper's PIM-amenability test over the *measured* op mix.

    Aggregates the telemetry's per-``(op, route)`` roofline estimates
    into one :class:`~repro_torch.core.amenability.PrimitiveProfile` per
    op (decode / prefill / verify, routes summed: the traffic is a
    property of the math, not the route) and feeds each through
    :func:`~repro_torch.core.amenability.run_test`.  ``pim`` and ``gpu``
    are the paper's simulated machines (:mod:`repro_torch.core.hwspec`),
    not the card.

    Returns ``{op: AmenabilityReport}``; empty when telemetry recorded
    nothing (disabled, or no paged-attention calls).
    """
    from ...core.amenability import Interaction, PrimitiveProfile, run_test
    interactions = {
        # one query row, dot-reduce over its resident KV: commutative
        # page-at-a-time accumulation (flash online softmax)
        "decode": Interaction.REDUCTION,
        # chunked causal block: query rows x KV pages interact within
        # the slot's own pages: localized, co-alignable per slot
        "prefill": Interaction.LOCALIZED,
        "verify": Interaction.LOCALIZED,
    }
    agg: dict = {}
    for (op, _route), d in _TELEMETRY.stats.items():
        a = agg.setdefault(op, {"flops": 0.0, "bytes": 0.0, "onchip": 0.0})
        a["flops"] += d["flops"]
        a["bytes"] += d["bytes"]
        a["onchip"] += d["onchip_bytes"]
    reports: dict = {}
    for op, a in sorted(agg.items()):
        if a["bytes"] + a["onchip"] <= 0.0:
            continue
        profile = PrimitiveProfile(
            name=f"paged-attn/{op}",
            ops=a["flops"],
            mem_bytes=a["bytes"],
            onchip_bytes=a["onchip"],
            interaction=interactions.get(op, Interaction.IRREGULAR),
            alignable=True,
            input_dependent_locality=True,
            notes="measured mix; page-table indirection makes locality "
                  "input-dependent (which pages a slot touches is data)")
        reports[op] = run_test(profile, pim, gpu)
    return reports


def _capturing(device: torch.device) -> bool:
    """Whether a call on ``device`` is being captured into a CUDA graph
    (the port's counterpart of a JAX trace): nothing may sync or read the
    device then."""
    return (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _host_i64(x) -> np.ndarray:
    """``x`` (an int, a sequence or a tensor on any device) as a host
    int64 vector; a CUDA tensor syncs."""
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1).to("cpu", torch.int64).numpy()
    return np.asarray(x, dtype=np.int64).reshape(-1)


def _traffic(q, k_pages, table, lengths, q_offset=None, *,
             concrete: bool = True) -> tuple:
    """Analytic ``(mem_bytes, flops, onchip_bytes)`` for one call, the
    arithmetic of JAX's ``_traffic`` in numpy int64/float64.

    Physical K/V traffic counts only *live* pages, the pages the
    kernels' walk actually reads.  Decode: ``ceil(lengths[b] / ps)``
    pages per slot; prefill/verify additionally bounds the walk at the
    causal end ``q_offset[b] + Lq``.  With ``concrete`` False (a call
    captured in a CUDA graph: its lengths are device values the capture
    must not read) the full caller-sliced table width is assumed live, an
    upper bound consistent with the grid the kernel was captured with.

    FLOPs are 4 x Hq x D per causally-visible (query, kv) pair (QK^T and
    PV, 2 each).  On-chip bytes are the logical K/V reads in excess of
    the physical ones: the GQA group (G query heads per KV head) and the
    Lq query rows of a chunk re-read each resident page from on-chip
    storage, not device memory.
    """
    b = int(q.shape[0])
    lq = int(q.shape[1]) if q.dim() == 4 else 1
    hq = int(q.shape[-2])
    d = int(q.shape[-1])
    ps, hkv = int(k_pages.shape[1]), int(k_pages.shape[2])
    p = int(table.shape[-1])
    item = k_pages.element_size()
    qitem = q.element_size()

    if not concrete:
        # abstract metadata: the whole sliced table is assumed live
        kv_end = np.full((b,), p * ps, dtype=np.int64)
        visible = float(b * lq * p * ps)
    else:
        ln = np.broadcast_to(_host_i64(lengths), (b,)).astype(np.int64)
        if q_offset is None:
            # decode: one query per slot sees its whole resident context
            kv_end = np.minimum(ln, p * ps)
            visible = float(kv_end.sum())
        else:
            # prefill/verify: causal suffix rows at absolute depths
            off = np.broadcast_to(_host_i64(q_offset),
                                  (b,)).astype(np.int64)
            kv_end = np.minimum(np.minimum(ln, off + lq), p * ps)
            i = np.arange(lq, dtype=np.int64)[None, :]
            vis = np.minimum(off[:, None] + i + 1, ln[:, None])
            visible = float(np.clip(vis, 0, p * ps).sum())
    live_pages = np.minimum((np.maximum(kv_end, 0) + ps - 1) // ps, p)
    kv_phys = float(live_pages.sum()) * ps * hkv * d * item * 2
    mem = kv_phys + 2.0 * b * lq * hq * d * qitem + b * p * 4.0
    flops = 4.0 * hq * d * visible
    kv_logical = visible * hq * d * item * 2
    return mem, flops, max(0.0, kv_logical - kv_phys)


def _recorded(op: str, route: str, q: torch.Tensor, fn, *args,
              traffic: tuple = (0.0, 0.0, 0.0), **kw):
    """Run ``fn(*args, **kw)``, attributing it to ``(op, route)``.

    Token volume comes from ``q``'s shape (B x Lq; Lq = 1 for [B, H, D]
    decode queries).  A call made during a CUDA-graph capture is counted
    but not timed: a sync there is illegal, and it would time the capture.
    An eager call on the card is timed between two device syncs.
    ``traffic`` is the caller's :func:`_traffic` estimate, accumulated
    alongside."""
    tel = _TELEMETRY
    tokens = int(q.shape[0]) * (int(q.shape[1]) if q.dim() == 4 else 1)
    mem, flops, onchip = traffic
    if _capturing(q.device):
        tel._bump(op, route, tokens, traced=True, mem_bytes=mem,
                  flops=flops, onchip_bytes=onchip)
        return fn(*args, **kw)
    cuda = q.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(q.device)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if cuda:
        torch.cuda.synchronize(q.device)
    tel._bump(op, route, tokens, wall=time.perf_counter() - t0,
              mem_bytes=mem, flops=flops, onchip_bytes=onchip)
    return out


def _call_traffic(q, k_pages, table, lengths, q_offset=None) -> tuple:
    """:func:`_traffic` for an op call, abstract under capture."""
    return _traffic(q, k_pages, table, lengths, q_offset,
                    concrete=not _capturing(q.device))


def _clamp_table(table: torch.Tensor, n_pages: int) -> torch.Tensor:
    return table.to(torch.int32).clamp(max=n_pages - 1).contiguous()


def _per_slot(x, b: int, device: torch.device) -> torch.Tensor:
    """A scalar or [B] vector as a contiguous int32 [B] tensor."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(b).contiguous()


def _policy():
    from ..decode_attn.ops import active_policy
    return active_policy()


def _tuned_launch(op: str, q, k_pages, *, lg: int) -> dict:
    """The active policy's tuned launch for this call's (device type, op,
    geometry), ``{}`` on a miss or with tuned loading off.  Shapes are
    host values even under capture, so resolution works there too (and
    is baked into the graph)."""
    return _policy().tuned_config(
        op, hq=int(q.shape[-2]), hkv=int(k_pages.shape[2]),
        d=int(q.shape[-1]), page_size=int(k_pages.shape[1]), lg=lg,
        backend=q.device.type) or {}


def _paged_attn_kernel(q, k_pages, v_pages, table, lengths, *,
                       ctas_per_sm, cta_rows):
    return kernel.paged_attn_cuda(
        q, k_pages, v_pages, _clamp_table(table, k_pages.shape[0]),
        _per_slot(lengths, q.shape[0], q.device), ctas_per_sm=ctas_per_sm,
        cta_rows=cta_rows)


def paged_attn(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               table: torch.Tensor, lengths: torch.Tensor, *,
               ctas_per_sm: int | None = None,
               cta_rows: int | None = None) -> torch.Tensor:
    """q: [B, Hq, D] one-token queries; k_pages/v_pages: [N, ps, Hkv, D]
    pooled pages; table: [B, P] int32; slot b attends over the first
    ``lengths[b]`` tokens of its pages in table order.  On the kernel
    route ``ctas_per_sm`` / ``cta_rows`` left None resolve through the
    policy's tuned-launch cache, else the kernel's defaults; the plain
    route (:func:`paged_attn_gather`) ignores them.  Returns q's dtype."""
    if not _policy().kernel_wanted(q.device):
        return paged_attn_gather(q, k_pages, v_pages, table, lengths)
    if ctas_per_sm is None or cta_rows is None:
        cfg = _tuned_launch("decode", q, k_pages,
                            lg=int(q.shape[-2]) // int(k_pages.shape[2]))
        if ctas_per_sm is None:
            ctas_per_sm = cfg.get("ctas_per_sm", split.CTAS_PER_SM)
        if cta_rows is None:
            cta_rows = cfg.get("cta_rows", split.CTA_ROWS)
    if not _TELEMETRY.enabled:
        return _paged_attn_kernel(q, k_pages, v_pages, table, lengths,
                                  ctas_per_sm=ctas_per_sm,
                                  cta_rows=cta_rows)
    return _recorded("decode", "kernel", q, _paged_attn_kernel,
                     q, k_pages, v_pages, table, lengths,
                     traffic=_call_traffic(q, k_pages, table, lengths),
                     ctas_per_sm=ctas_per_sm, cta_rows=cta_rows)


def _paged_attn_gather_impl(q, k_pages, v_pages, table, lengths):
    return ref.paged_attn_ref(q, k_pages, v_pages, table,
                              lengths).to(q.dtype)


def paged_attn_gather(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Gather-then-attend, the counterpart of JAX's ``paged_attn_xla``:
    the same function as :func:`paged_attn` in plain PyTorch, on either
    device (the ``"plain"`` route).  Returns q's dtype."""
    if _TELEMETRY.enabled:
        return _recorded("decode", "plain", q, _paged_attn_gather_impl,
                         q, k_pages, v_pages, table, lengths,
                         traffic=_call_traffic(q, k_pages, table, lengths))
    return _paged_attn_gather_impl(q, k_pages, v_pages, table, lengths)


def _paged_prefill_kernel(q, k_pages, v_pages, table, q_offset, kv_len, *,
                          block_rows):
    b = q.shape[0]
    return kernel.paged_prefill_attn_cuda(
        q.contiguous(), k_pages, v_pages,
        _clamp_table(table, k_pages.shape[0]),
        _per_slot(q_offset, b, q.device), _per_slot(kv_len, b, q.device),
        block_rows=block_rows)


def paged_prefill_attn(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, table: torch.Tensor,
                       q_offset: torch.Tensor,
                       kv_len: torch.Tensor, *,
                       block_rows: int | None = None,
                       _op: str | None = None) -> torch.Tensor:
    """Multi-token causal GQA queries ``q`` [B, L, Hq, D] at per-slot
    depths ``q_offset`` [B] over pooled pages, masked to each slot's
    ``kv_len``: whole-prompt prefill (``q_offset`` 0), suffix prefill
    (``q_offset`` the resident depth) and speculative verify alike.  On
    the kernel route ``block_rows`` left None resolves through the
    policy's tuned-launch cache for this call's op (``decode`` at L = 1,
    ``prefill`` otherwise, or ``_op``), else the kernel's default; the
    plain route ignores it."""
    op = _op or ("decode" if q.shape[1] == 1 else "prefill")
    if _policy().kernel_wanted(q.device):
        if block_rows is None:
            g = int(q.shape[2]) // int(k_pages.shape[2])
            block_rows = _tuned_launch(op, q, k_pages,
                                       lg=int(q.shape[1]) * g).get(
                "block_rows", kernel.BLOCK_ROWS)
        if _TELEMETRY.enabled:
            return _recorded(op, "kernel", q, _paged_prefill_kernel,
                             q, k_pages, v_pages, table, q_offset, kv_len,
                             traffic=_call_traffic(q, k_pages, table,
                                                   kv_len, q_offset),
                             block_rows=block_rows)
        return _paged_prefill_kernel(q, k_pages, v_pages, table, q_offset,
                                     kv_len, block_rows=block_rows)
    if _TELEMETRY.enabled:
        return _recorded(op, "plain", q, ref.paged_prefill_attn_ref,
                         q, k_pages, v_pages, table, q_offset, kv_len,
                         traffic=_call_traffic(q, k_pages, table, kv_len,
                                               q_offset))
    return ref.paged_prefill_attn_ref(q, k_pages, v_pages, table, q_offset,
                                      kv_len)


def paged_verify_attn(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor,
                      q_offset: torch.Tensor,
                      kv_len: torch.Tensor, *,
                      block_rows: int | None = None) -> torch.Tensor:
    """Speculative-decode verify: the current token plus k drafts
    (``q`` [B, k+1, Hq, D]) at the slot's decode depth ``q_offset``.  This
    is exactly :func:`paged_prefill_attn` at Lq = k+1, under its serving
    name and its own tuned-launch entry (see
    ``repro.kernels.paged_attn.ops.paged_verify_attn``)."""
    return paged_prefill_attn(q, k_pages, v_pages, table, q_offset, kv_len,
                              block_rows=block_rows, _op="verify")
