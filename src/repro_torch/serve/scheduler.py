"""Slot-based continuous batching over the decode loop, from
:mod:`repro.serve.scheduler` (``ContinuousBatcher``).

The scheduler owns ``cfg.batch`` decode slots.  Requests queue in
arrival order.  Between decode segments (``cfg.sync_every`` steps, the
only host syncs), free slots are refilled from the queue: the joining
prompts are padded to one power-of-two width and prefilled in one call.
A slot retires when it emits EOS (kept) or exhausts its budget.

Two KV layouts, as in JAX (``cfg.paged``):

- Dense (the default): each slot owns a stripe of ``max_len`` rows, so
  admission needs only a free slot.  The join writes the joining slots'
  rows only.  Each segment bounds the rows attention reads to a
  power-of-two bucket over the deepest live slot plus the segment's steps
  (``_kv_cap``), so the decode kernel never walks rows past every slot's
  depth.
- Paged: the slots share one pooled allocation.  A request is admitted
  when the pool can hold its worst case (prompt + budget pages, "reserve"
  admission) or, optimistic, its prompt's pages; rows outside the join
  write nothing to live pages; a retired slot's pages go back to the pool
  at the segment boundary.  Each segment slices the page table to a
  power-of-two bound on the deepest live slot's page count (page-cap
  bucketing).

A model with SSM segments (mamba2-370m; the zamba2-1.2b hybrid) keeps
each slot's conv window and recurrent state beside the KV, per slot in
both layouts: a join starts a joining row's from zero and stops it at
the row's own prompt length, so the padding of the join's width never
enters it, and the decode steps continue it.  A recurrent state cannot be
rebuilt from pages or rolled back, so optimistic admission, chunked
prefill, speculation and the prefix cache are refused for such a model,
in JAX's words.

The slot state (``tok``, ``lengths``, ``done``, ``remaining``), the
caches and, paged, one ``[B, P_cap]`` slice of the page table per bucket
are device tensors made once and written in place: the joins write the
joining rows into them, and each decode segment reads and writes them.
On a CUDA device each ``(steps, kv_cap)`` bucket (dense) or ``(steps,
P_cap)`` bucket (paged) is one CUDA graph, captured after an eager
warm-up segment of the same bucket and replayed for every later segment
(``graphs``; :class:`repro_torch.serve.engine.GraphedLoop`), as JAX
keys one executable per bucket.  Sampled runs (a temperature above 0)
are graphed too: the batcher's generator is registered with each graph.
The joins stay eager: their width changes with every refill.

Admission (``cfg.admission``): ``"fifo"`` (the default) admits the queue
head or nothing; ``"skip-ahead"`` scans up to ``cfg.admission_lookahead``
queued requests for the first whose pages fit when the head does not,
charging each request it passes one skip; a request skipped
``cfg.admission_max_skips`` times becomes a barrier that nothing passes
until it fits.  Dense stripes admit on a free slot alone.

Prefix cache (``cfg.prefix_cache``, paged; :mod:`.prefixcache`):
admission matches the prompt against a radix tree of page-aligned cached
chunks, maps the matched pages into the slot (``KVPool.share``) and
prefills only the uncached suffix, at that depth; a hit needs free pages
for suffix and budget only.  The pages the first chunk covers are
registered before the join, so queue-mates of the same round already hit
(the join writes a page before any row of it reads one).  A retiring
slot's registered pages park evictable-cached, reclaimed LRU and
leaf-first when the pool runs short.

Chunked prefill (``cfg.prefill_chunk``, paged): a prompt's uncached
suffix is prefilled in page-aligned chunks, one a refill round, the slot
PREFILLING in between (done-latched on the device: no sampling, PAD
emissions), so the live slots' decode segments run between the chunks.
Each continuation is a join at the filled depth; only the last chunk
samples a first token (``commit_mask``).  ``cfg.prefill_round_tokens``
caps the prefill tokens of one round: continuations past it wait a round
and admission stops (``join_stats()["budget_deferrals"]``); the first
piece of a round always goes through.

Self-speculative decoding (``cfg.speculate_k``, paged, greedy): decode
segments run the draft-k verify loop (``engine.make_decode_loop``), 1 to
k+1 tokens a slot and step, the plain greedy loop's tokens up to
rounding.
Admission reserves the speculation window (prompt + budget + k tokens:
a verify writes K/V up to ``lengths + k``), and so does ``run``'s
up-front check.  The drafter reads a device ``history`` [B, max_len + 1]
written in place: the prompt at admission and the first token at commit
here, the committed tokens by the loop.  ``_collect`` walks each step's
burst and feeds ``spec_stats``.

Optimistic admission (``cfg.admission_mode="optimistic"``, paged): a
request is admitted on its prompt's pages alone, and before each decode
segment every decoding slot's table grows to cover the segment's
worst-case advance (``steps * (k + 1)`` tokens, capped by the slot's
total budget; ``_ensure_decode_pages``), highest priority first.  When the
pool cannot cover a growth, a victim is preempted.  The victim policy is
deterministic: a request preempted ``admission_max_skips`` times is
protected (picked last), then the lowest priority class (``submit(...,
priority=)``), the most pages mapped, the least decode progress and the
lowest slot id.  Preemption registers the victim's full pages in the
radix tree (with the prefix cache), releases its pages (its dead private
pages park in the pool's preempted partition), latches its device row
done in place, and re-queues it at the queue head with prompt = its
prompt + every committed token.  The resume is recompute-on-resume: an
ordinary (chunked, prefix-matched) join over that history, whose first
sampled token is the next one the uninterrupted run would give, with a
device budget of the tokens still owed.  An often-preempted request
becomes an admission barrier (the skip-ahead aging), so every preempted
request completes.  ``chaos=`` (:class:`~repro_torch.serve.chaos.
ChaosInjector`, paged) forces pool exhaustion, victim choices, slot
failures (a failure is a preemption), dead rounds (``stall_at``) and
queue bursts (``burst_at``) at given scheduling rounds (``round``).

Overload protection (:mod:`.overload`), as in JAX.  Deadlines and
cancellation are always on: ``submit(deadline_s=, timeout_s=)`` stamps a
request, and a sweep each round cancels the requests whose stamp passed
or whose remaining budget, at the observed TTFT/TPOT means, can no longer
meet the deadline.  CANCELLED is terminal: a queued request just leaves
the queue; a PREFILLING or DECODING one releases its pages and its device
row is latched done in place, as a preemption's is, minus the re-queue.
``cfg.overload`` arms the degradation controller (HEALTHY -> DEGRADED ->
SHEDDING on the SLO burn rate and the pool pressure): DEGRADED sheds
speculation (the plain loop's graph for the bucket then runs, and its
commits keep the drafter's history warm) and halves the prefill chunk;
SHEDDING also admits at the worst case again and sheds the
lowest-priority queued work with a retryable RETRY_AFTER rejection.
Degradation changes when and whether work runs, never the tokens of a
request that completes.  A progress watchdog (``cfg.watchdog_rounds``
rounds with no join, commit, retirement, preemption or cancellation while
work exists) dumps the flight bundle and force-sheds the blocking head,
so a stalled drain finishes instead of looping.

Accounting, at the host sync points as in JAX: time to first token (run
start to the join that sampled it), time per output token, queue wait and
join seconds go into a :class:`~repro_torch.serve.telemetry.
MetricsRegistry` (``latency_stats``, ``join_stats``), and so do the
prefill, prefix, chunk, speculation, preemption, cancellation, deadline
and SLO counters (``prefix_stats``, ``spec_stats``, ``preempt_stats``,
``overload_stats``, ``slo_stats``); KV use is sampled once a segment
(``kv_utilization``); ``reset_stats`` clears them between waves.  With
``cfg.telemetry`` (or a ``telemetry=`` :class:`~repro_torch.serve.
telemetry.Tracer`) every lifecycle event, the per-round spans and the
pool's partitions are traced, for :mod:`.attribution` and a Perfetto
file, beside the port's inner spans (each ``round``, its ``sweep`` and
``admit``, and the model's parts inside a join, recorded through
:mod:`repro_torch.parthook`, which the batcher arms around a traced join
only).  The ``join`` and ``decode-segment`` spans carry the work they
did (rows, width, joining rows, prompt and committed tokens; steps, live
rows, keys read, tokens emitted) and, on the card, their device interval:
CUDA events, turned into host-clock seconds at the two host syncs the
batcher makes anyway (the join's first-token read and the segment's
emitted-token read).  Tracing adds no sync: a traced segment ends, as an
untraced one does, at its ``.cpu()`` read.  The flight recorder, on by
default, keeps the last ``cfg.flight_events`` events in a ring (host
appends only: no sync, no gauge callback) and dumps them with the slot
table and the pool when a ``PageError`` escapes ``run`` or the watchdog
trips.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..configs.base import BlockKind
from .engine import (PAD_TOKEN, GraphedLoop, ServeConfig, make_decode_loop,
                     make_join, make_paged_join)
from ..kernels.decode_attn.ops import DecodeAttnPolicy
from .kvpool import KVPool, PageError
from .overload import (CANCEL_REASONS, HEALTHY, RETRY_AFTER, STATES,
                       DegradationController, Watchdog, WatchdogStall,
                       project_finish_s)
from .prefixcache import PrefixCache
from .telemetry import CudaTimer, MetricsRegistry, Tracer
from .. import parthook
from ..models.model_zoo import Model


def _pow2_bucket(n: int, lo: int = 16, hi: int | None = None) -> int:
    b = max(lo, 1 << max(0, n - 1).bit_length())
    return min(b, hi) if hi is not None else b


class ContinuousBatcher:
    """Greedy (or sampled) continuous batcher over a fixed slot table.

    The device is the one the parameters live on; the pools, the slot
    state and the sampling generator are made there.  ``graphs`` picks how
    a decode segment runs: None (the default) replays one CUDA graph per
    bucket on a CUDA device and runs the eager loop on the CPU; False runs
    the eager loop on the card too (the A/B of the tests and the chip
    tools); True on the CPU raises.  ``chaos`` (paged) is a
    :class:`~repro_torch.serve.chaos.ChaosInjector` called at the top of
    every scheduling round.  ``telemetry`` is a
    :class:`~repro_torch.serve.telemetry.Tracer` to record into (None:
    one of its own when ``cfg.telemetry``, else no tracing).

    Attention routes by ``cfg.attn_mode`` through one
    :class:`~repro_torch.kernels.decode_attn.ops.DecodeAttnPolicy` built
    here, so the tuned launches are loaded once, when the batcher is
    built: every join and decode loop runs inside it, and a graph is
    captured under it.  ``ServeConfig`` is frozen, so the mode holds for
    the batcher's life, and a later rewrite of the tuned-launch cache never
    meets a graph captured under the old entries."""

    def __init__(self, model: Model, params, cfg: ServeConfig,
                 eos_id: int | None = None, seed: int = 0,
                 graphs: bool | None = None, chaos=None,
                 telemetry: Tracer | None = None):
        self.model, self.params, self.cfg = model, params, cfg
        self.eos = eos_id
        # the feature checks of repro.serve.scheduler, in its order and
        # words, before ``params`` is read or a cache allocated (JAX's
        # tests build a hybrid-SSM batcher with no params to see them)
        recurrent = any(s.kind is BlockKind.SSM
                        for s in model.cfg.resolved_segments())
        if cfg.admission_mode not in ("reserve", "optimistic"):
            raise ValueError(
                f"unknown admission mode {cfg.admission_mode!r} "
                "(expected 'reserve' or 'optimistic')")
        if cfg.admission_mode == "optimistic":
            if not cfg.paged:
                raise ValueError(
                    "admission_mode='optimistic' requires paged=True "
                    "(on-demand growth and preemption move pages through "
                    "the pool)")
            if recurrent:
                raise ValueError(
                    "optimistic admission is attention-only: preempting a "
                    "hybrid SSM slot would discard a recurrent state that "
                    "recompute-on-resume cannot rebuild from paged KV")
        self.chaos = chaos
        if chaos is not None and not cfg.paged:
            raise ValueError("chaos injection requires paged=True (its "
                             "faults move pages through the pool)")
        if cfg.prefill_chunk is not None:
            if not cfg.paged:
                raise ValueError("prefill_chunk requires paged=True "
                                 "(chunks resume through the page table)")
            if cfg.prefill_chunk <= 0:
                raise ValueError("prefill_chunk must be positive")
            if cfg.prefill_chunk % cfg.page_size:
                raise ValueError(
                    f"prefill_chunk {cfg.prefill_chunk} must be a multiple "
                    f"of page_size {cfg.page_size} (chunk boundaries must "
                    "never land inside a shared prefix page)")
            if recurrent:
                raise ValueError(
                    "prefill_chunk is attention-only: a hybrid SSM "
                    "model's recurrent state cannot resume mid-prompt "
                    "across join calls")
        if cfg.prefill_round_tokens is not None \
                and cfg.prefill_round_tokens <= 0:
            raise ValueError("prefill_round_tokens must be positive")
        self.spec_k = cfg.speculate_k or 0
        if cfg.speculate_k is not None:
            if not cfg.paged:
                raise ValueError(
                    "speculate_k requires paged=True (the verify step "
                    "writes and rolls back through the page table)")
            if cfg.speculate_k < 1:
                raise ValueError("speculate_k must be >= 1")
            if cfg.speculate_ngram < 1:
                raise ValueError("speculate_ngram must be >= 1")
            if cfg.temperature != 0.0:
                raise ValueError(
                    "speculate_k is greedy-only for now: acceptance is "
                    "defined by exact argmax agreement (temperature 0)")
            if recurrent:
                raise ValueError(
                    "speculate_k is attention-only: a hybrid SSM model's "
                    "recurrent state advances k+1 tokens per verify and "
                    "cannot roll back past the acceptance point")
        if cfg.prefix_cache:
            if not cfg.paged:
                raise ValueError("prefix_cache requires paged=True "
                                 "(shared pages live in the block pool)")
            if recurrent:
                raise ValueError(
                    "prefix_cache is attention-only: hybrid SSM models "
                    "cannot resume a recurrent state from cached pages")
        if cfg.watchdog_rounds < 1:
            raise ValueError("watchdog_rounds must be >= 1")
        self.device = dev = params["embed"]["table"].device
        if graphs is None:
            graphs = dev.type == "cuda"
        elif graphs and dev.type != "cuda":
            raise ValueError("graphs=True needs a CUDA device: on the CPU "
                             "the decode loop runs eagerly")
        self.graphs = graphs
        if graphs:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)
        self.attn_policy = DecodeAttnPolicy(mode=cfg.attn_mode)
        b = cfg.batch
        if cfg.paged:
            self.pool = KVPool(cfg.pool_pages, cfg.page_size, b,
                               max_pages=cfg.max_pages)
            self.caches = model.init_paged_caches(
                b, cfg.pool_pages, cfg.page_size, cfg.dtype, device=dev)
            self._join = make_paged_join(model, cfg, eos_id=eos_id,
                                         policy=self.attn_policy)
        else:
            self.pool = None
            self.caches = model.init_caches(b, cfg.max_len, cfg.dtype,
                                            device=dev)
            self._join = make_join(model, cfg, eos_id=eos_id,
                                   policy=self.attn_policy)
        self.prefix = PrefixCache(self.pool) if cfg.prefix_cache else None
        # every per-wave stat lives in the registry; the tracer is
        # optional (None keeps each event call site a skipped ``if``)
        self.metrics = MetricsRegistry()
        self.telemetry = telemetry
        if telemetry is None and cfg.telemetry:
            self.telemetry = Tracer(device_timer=CudaTimer(dev)
                                    if dev.type == "cuda" else None)
        # flight recorder: an always-on bounded ring of the same lifecycle
        # events (host dict appends only: no spans, no pool gauge
        # callback, no device sync), dumped by ``_dump_flight``
        self.flight = (Tracer(ring=cfg.flight_events)
                       if cfg.flight_recorder else None)
        self.last_flight_bundle: dict | None = None
        # priority classes that have scored an SLO sample (the met/total
        # counters live in the registry)
        self._slo_classes: set[int] = set()
        if self.telemetry is not None and self.pool is not None:
            # every allocator mutation lands one counter sample in the
            # trace (and the current-state gauges)
            self.pool.gauge_cb = self._on_pool_gauge
        # decode loops by (steps, kv_cap, spec) (dense) or (steps, P_cap,
        # spec) (paged): the eager loop, or its graph
        self._loops: dict[tuple[int, int | None, bool], object] = {}
        self._pages: dict[int, torch.Tensor] = {}   # P_cap -> [B, P_cap]
        self.tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.done = torch.ones((b,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        # the drafter's token history (speculation only): [B, max_len]
        # positions and a spare column that takes the writes JAX drops
        self.history = (torch.zeros((b, cfg.max_len + 1), dtype=torch.int32,
                                    device=dev) if self.spec_k else None)
        self.queue: collections.deque[tuple[int, list[int]]] = \
            collections.deque()
        self.results: dict[int, list[int]] = {}
        self.outputs: dict[int, list[int]] = {}
        # host mirror of the slot table
        self.slot_rid: list[int | None] = [None] * b
        self.slot_budget = [0] * b
        self.slot_len = [0] * b          # tokens in each slot's cache
        # chunked prefill: a slot with pending suffix tokens is PREFILLING
        # (done-latched on the device); ``slot_filled`` is its resident
        # prompt depth, ``slot_prompt`` the whole prompt
        self.slot_pending: list[list[int]] = [[] for _ in range(b)]
        self.slot_prompt: list[list[int] | None] = [None] * b
        self.slot_filled = [0] * b
        self.admit_order: list[int] = []
        # skip-ahead aging: times each queued rid has been bypassed
        self._skips: dict[int, int] = {}
        # joins and decode segments over the batcher's life, and the
        # segments that ran the verify loop (reset_stats keeps them: the
        # chip tools' launch checks read them)
        self.joins = 0
        self.segments = 0
        self.spec_segments = 0
        # KV use, sampled once a segment as (live tokens, allocated token
        # capacity, live slots)
        self.kv_samples: list[tuple[int, int, int]] = []
        self._clock0: float | None = None
        self._first_tok_t: dict[int, float] = {}
        self._submit_t: dict[int, float] = {}
        # optimistic admission and preemption: each request's priority
        # class (the victim policy evicts the lowest first), each slot's
        # token ceiling (prompt + remaining budget + speculation window:
        # what on-demand growth may cover) and the committed tokens that
        # predate its admission (a resume's prompt already holds them), the
        # rids between a preemption and their retirement, and each rid's
        # preemptions
        self.req_priority: dict[int, int] = {}
        self.slot_max_tokens = [0] * b
        self.slot_prior = [0] * b
        self._resumed: set[int] = set()
        self._preempt_counts: dict[int, int] = {}
        self.preempted_rids: set[int] = set()
        self.preempt_events: list[tuple[int, int, int, str]] = []
        # overload protection: per-request absolute deadline and timeout
        # stamps, terminal cancellations (rid -> reason), the RETRY_AFTER
        # rejections shed queued work was answered with, the opt-in
        # degradation controller and the always-on progress watchdog
        self._deadline_t: dict[int, float] = {}
        self._timeout_t: dict[int, float] = {}
        self.cancelled: dict[int, str] = {}
        self.rejections: list[dict] = []
        self.overload = (DegradationController(
            degrade_burn=cfg.overload_degrade_burn,
            shed_burn=cfg.overload_shed_burn,
            degrade_pressure=cfg.overload_degrade_pressure,
            shed_pressure=cfg.overload_shed_pressure,
            up_rounds=cfg.overload_up_rounds,
            down_rounds=cfg.overload_down_rounds)
            if cfg.overload else None)
        self.watchdog = Watchdog(cfg.watchdog_rounds)
        # chaos ``stall_at``: rounds below this bound skip the whole round
        # body; ``_max_new`` is the running drain's budget (the chaos
        # burst sizes its prompts by it)
        self._stall_until = 0
        self._max_new = 0
        # scheduling rounds of ``run`` (the chaos injector keys on it)
        self.round = 0

    # counter views over the registry, under JAX's attribute names
    @property
    def prefill_computed(self) -> int:
        return int(self.metrics.value("prefill.computed_tokens"))

    @property
    def prefill_skipped(self) -> int:
        return int(self.metrics.value("prefill.skipped_tokens"))

    @property
    def prefix_admits(self) -> int:
        return int(self.metrics.value("prefix.admits"))

    @property
    def prefix_hits(self) -> int:
        return int(self.metrics.value("prefix.hits"))

    @property
    def chunk_joins(self) -> int:
        return int(self.metrics.value("join.chunk_continuations"))

    @property
    def budget_deferrals(self) -> int:
        return int(self.metrics.value("join.budget_deferrals"))

    @property
    def preemptions(self) -> int:
        return int(self.metrics.value("preempt.count"))

    @property
    def preempted_token_recompute(self) -> int:
        return int(self.metrics.value("preempt.recompute_tokens"))

    # ------------------------------------------------------------------
    # telemetry plumbing: every call site is at a host sync point or a
    # round boundary, and costs an attribute test with tracing off
    # ------------------------------------------------------------------
    def _on_pool_gauge(self, **counts) -> None:
        tr = self.telemetry
        if tr is not None:
            tr.pool_gauge(counts)
        for k, v in counts.items():
            self.metrics.set_gauge(f"pool.{k}_pages", v)

    def _trace(self, kind: str, rid: int | None,
               slot: int | None = None, **attrs) -> None:
        """One lifecycle event into the tracer and the flight recorder,
        stamped with the round, the slot's pages and the pool's free
        pages (``pages_held`` and ``pool_free`` in ``attrs`` replace
        them)."""
        tr, fl = self.telemetry, self.flight
        if tr is None and fl is None:
            return
        pages = (len(self.pool.slot_pages(slot))
                 if self.pool is not None and slot is not None else 0)
        free = self.pool.free_pages if self.pool is not None else 0
        pages_held = attrs.pop("pages_held", pages)
        pool_free = attrs.pop("pool_free", free)
        for t in (tr, fl):
            if t is not None:
                t.event(kind, rid, round=self.round, slot=slot,
                        pages_held=pages_held, pool_free=pool_free, **attrs)

    def _slo_observe(self, metric: str, rid: int, v: float) -> None:
        """Score one observed latency against its configured SLO, per
        priority class; nothing when that metric's SLO is unset."""
        slo = (self.cfg.ttft_slo_s if metric == "ttft"
               else self.cfg.tpot_slo_s)
        if slo is None:
            return
        cls = self.req_priority.get(rid, 0)
        self._slo_classes.add(cls)
        self.metrics.inc(f"slo.{metric}_total.c{cls}")
        if v <= slo:
            self.metrics.inc(f"slo.{metric}_met.c{cls}")

    def submit(self, rid: int, prompt: list[int], priority: int = 0,
               deadline_s: float | None = None,
               timeout_s: float | None = None) -> None:
        """Queue a request.  ``priority`` is its class for the preemption
        victim policy: higher values are evicted later.

        ``deadline_s`` is the client's completion deadline, seconds from
        now: the per-round sweep cancels the request (reason
        ``"deadline"``) once it passes or once the remaining-budget
        TTFT/TPOT projection says it can no longer be met.  ``timeout_s``
        is a hard lifetime cap (reason ``"timeout"``), on expiry alone.
        Deadline attainment scores the deadline-carrying requests that
        completed or expired; shed and client cancels are not scored."""
        if not prompt:
            raise ValueError("empty prompt")
        now = time.perf_counter()
        if deadline_s is not None:
            if deadline_s < 0:
                raise ValueError("deadline_s must be >= 0")
            self._deadline_t[rid] = now + deadline_s
        if timeout_s is not None:
            if timeout_s < 0:
                raise ValueError("timeout_s must be >= 0")
            self._timeout_t[rid] = now + timeout_s
        self.queue.append((rid, list(prompt)))
        self.req_priority[rid] = priority
        self._submit_t[rid] = now
        self._trace("SUBMIT", rid, prompt_tokens=len(prompt),
                    priority=priority, deadline_s=deadline_s,
                    timeout_s=timeout_s)

    def _spec_live(self) -> int:
        """The speculation window in force this round: ``spec_k`` unless
        the degradation controller has shed speculation (DEGRADED and
        up).  The plain loop's tokens are the verify loop's, so shedding
        changes steps, not tokens (up to rounding on the card)."""
        if self.overload is not None and self.overload.shed_speculation:
            return 0
        return self.spec_k

    def _effective_chunk(self) -> int | None:
        """The prefill chunk in force this round: halved (page-aligned, at
        least a page) while the controller is DEGRADED and up, so joins
        stall the live slots for less.  An unchunked config stays
        unchunked."""
        chunk = self.cfg.prefill_chunk
        if (chunk is not None and self.overload is not None
                and self.overload.shrink_chunk):
            ps = self.cfg.page_size
            return max(ps, (chunk // 2) // ps * ps)
        return chunk

    def _loop(self, steps: int, cap: int | None = None):
        """The decode loop of ``(steps, cap, spec)``: ``cap`` is
        ``kv_cap`` on the dense path and the page table slice's width on
        the paged one, and ``spec`` whether it is the speculative loop
        (the key JAX's batcher uses: the controller may shed speculation
        mid-run, and the two loops take different tensors).  With graphs,
        the bucket's :class:`GraphedLoop`."""
        spec = self._spec_live()
        key = (steps, cap, bool(spec))
        if key not in self._loops:
            loop = make_decode_loop(
                self.model, self.cfg, steps=steps, eos_id=self.eos,
                kv_cap=None if self.cfg.paged else cap,
                paged=self.cfg.paged, speculate_k=spec,
                policy=self.attn_policy)
            if self.graphs:
                loop = GraphedLoop(loop, stream=self._capture_stream,
                                   pool=self._graph_pool,
                                   sampled=self.cfg.temperature > 0)
            self._loops[key] = loop
        return self._loops[key]

    @property
    def capture_seconds(self) -> float:
        """Seconds spent capturing and instantiating decode graphs."""
        return sum(loop.capture_s for loop in self._loops.values()
                   if isinstance(loop, GraphedLoop))

    @property
    def graph_count(self) -> int:
        """Decode graphs captured so far."""
        return sum(isinstance(loop, GraphedLoop) and loop.graph is not None
                   for loop in self._loops.values())

    def _kv_cap(self, steps: int) -> int | None:
        """Power-of-two bound on the rows the next ``steps`` decode steps
        read: the deepest live slot's cache length plus ``steps``.  None
        when it reaches ``max_len`` (read every row)."""
        live = [self.slot_len[i] for i, r in enumerate(self.slot_rid)
                if r is not None]
        if not live:
            return None
        cap = _pow2_bucket(max(live) + steps, hi=self.cfg.max_len)
        return None if cap >= self.cfg.max_len else cap

    def _page_cap(self) -> int:
        """Power-of-two bound on the deepest live slot's allocated page
        count (allocation covers prompt + budget, or optimistic growth
        covered the segment's advance before it, so a segment can never
        outgrow it)."""
        live = [len(self.pool.slot_pages(i))
                for i, r in enumerate(self.slot_rid) if r is not None]
        if not live:
            return self.cfg.max_pages
        return _pow2_bucket(max(live), lo=2, hi=self.cfg.max_pages)

    def _note_admitted(self, rid: int) -> None:
        """Close the request's queue-wait interval (opened at submit and
        re-opened at each preemption)."""
        t0 = self._submit_t.pop(rid, None)
        if t0 is not None:
            self.metrics.observe("lat.queue_wait_s",
                                 time.perf_counter() - t0)

    def _admit_next(self, slot: int, max_new: int):
        """Pop and reserve the next admissible queued request for
        ``slot``: ``(rid, prompt, matched_tokens)`` or None.  Dense, the
        queue head (a free slot is enough).  Paged, a request whose worst
        case (prompt + budget + speculation window; optimistic, its prompt)
        the pool can hold, beside the pages of its prompt that the prefix
        cache matches: those are shared into the slot and the rest is
        reserved.  A resume's prompt holds its committed tokens, so only
        the budget still owed counts toward its worst case.  FIFO takes the
        head or nothing; skip-ahead scans a window of
        ``admission_lookahead`` requests, charges each one it passes a
        skip, and never passes one whose skips reached
        ``admission_max_skips``.  With the prefix cache, the prompt pages
        that the request's first chunk covers are registered at once, so
        the round's later admissions already match them."""
        if not self.queue:
            return None
        if self.pool is None:
            rid, p = self.queue.popleft()
            self.admit_order.append(rid)
            self._note_admitted(rid)
            self._trace("ADMIT", rid, slot=slot, prompt_tokens=len(p))
            return rid, p, 0
        # SHEDDING freezes optimistic growth at the source: new admissions
        # take their worst case again (live optimistic slots still grow)
        optimistic = (self.cfg.admission_mode == "optimistic"
                      and not (self.overload is not None
                               and self.overload.freeze_growth))
        window = 1
        if self.cfg.admission == "skip-ahead":
            window = min(len(self.queue), self.cfg.admission_lookahead)
        for qi in range(window):
            rid, p = self.queue[qi]
            prior = (len(self.outputs.get(rid, ()))
                     if rid in self._resumed else 0)
            ceiling = len(p) + (max_new - prior) + self.spec_k
            matched, mtoks = [], 0
            if self.prefix is not None:
                matched, mtoks = self.prefix.match(p)
            admit_tokens = len(p) if optimistic else ceiling
            if not self.pool.can_admit(admit_tokens, shared_pages=matched):
                if self._skips.get(rid, 0) >= self.cfg.admission_max_skips:
                    break                # aged out: a barrier until it fits
                continue
            del self.queue[qi]
            for prev in range(qi):       # everything passed was blocked
                passed = self.queue[prev][0]
                self._skips[passed] = self._skips.get(passed, 0) + 1
            self._skips.pop(rid, None)
            self.admit_order.append(rid)
            self._note_admitted(rid)
            self.slot_max_tokens[slot] = ceiling
            if matched:
                # the matched chain's refcounts go above 1
                self.pool.share(slot, matched)
                total = self.pool.pages_for(admit_tokens)
                if total > len(matched):
                    self.pool.extend(slot, total - len(matched))
            else:
                self.pool.reserve(slot, admit_tokens)
            if self.prefix is not None:
                chunk = self._effective_chunk()
                covered = (len(p) if chunk is None
                           else min(len(p), mtoks + chunk))
                self._register_covered(slot, p, covered)
                self.metrics.inc("prefix.admits")
                self.metrics.inc("prefix.hits", int(bool(mtoks)))
            self._trace("ADMIT", rid, slot=slot, prompt_tokens=len(p),
                        matched_tokens=mtoks)
            if rid in self._resumed:
                # a resume re-enters through ordinary admission; RESUME
                # pairs with its PREEMPT
                self._trace("RESUME", rid, slot=slot,
                            prior_tokens=len(self.outputs.get(rid, ())))
            return rid, p, mtoks
        return None

    def _register_covered(self, slot: int, prompt: list[int],
                          covered: int) -> None:
        """Insert ``prompt``'s full pages up to ``covered`` resident
        tokens into the radix tree (chunks already there are kept, so a
        continuation extends the chain)."""
        ps = self.pool.page_size
        n_full = min(covered, len(prompt)) // ps
        if n_full:
            self.prefix.insert(prompt[:n_full * ps],
                               self.pool.slot_pages(slot)[:n_full])

    def _release_slot(self, slot: int, preempt: bool = False) -> None:
        """Return ``slot``'s pages: registered prefix pages whose refcount
        reaches 0 park evictable-cached, the rest go back to the free list
        (with ``preempt``, to the pool's preempted partition).  Clears the
        slot's prefill and admission state."""
        if self.pool is not None:
            cacheable = frozenset()
            if self.prefix is not None:
                cacheable = self.prefix.registered_pages(
                    self.pool.slot_pages(slot))
            self.pool.release(slot, cacheable=cacheable, preempt=preempt)
        self.slot_pending[slot] = []
        self.slot_prompt[slot] = None
        self.slot_filled[slot] = 0
        self.slot_prior[slot] = 0
        self.slot_max_tokens[slot] = 0

    def _retire(self, slot: int, rid: int, out: list[int],
                now: float) -> None:
        """Retire ``rid`` from ``slot`` at host time ``now``: score its
        deadline, trace RETIRE (with the pages it still holds), release
        the slot and observe its time per output token (requests of more
        than one token)."""
        self.results[rid] = out
        self.slot_rid[slot] = None
        self._resumed.discard(rid)
        self._preempt_counts.pop(rid, None)
        self._note_deadline_done(rid, now)
        tpot = 0.0
        if (self._clock0 is not None and len(out) > 1
                and rid in self._first_tok_t):
            tpot = (now - self._first_tok_t[rid]) / (len(out) - 1)
        self._trace("RETIRE", rid, slot=slot, tokens=len(out), tpot_s=tpot)
        self._release_slot(slot)
        if tpot > 0.0:
            self.metrics.observe("lat.tpot_s", tpot)
            self._slo_observe("tpot", rid, tpot)

    # ------------------------------------------------------------------
    # page-level preemption (optimistic admission, chaos slot failure),
    # from repro.serve.scheduler
    # ------------------------------------------------------------------
    def _preempt_slot(self, slot: int, reason: str = "pressure") -> None:
        """Evict a live slot at a segment boundary: register its covered
        pages in the radix tree (so the resume can match them), release
        its pages (unregistered ones park in the pool's preempted
        partition), latch its device row done, and re-queue the request at
        the queue head with prompt = everything committed so far, which
        the ordinary (chunked) prefill join recomputes."""
        rid = self.slot_rid[slot]
        if rid is None:
            raise RuntimeError(f"preempt of empty slot {slot}")
        prompt = self.slot_prompt[slot]
        if self.slot_pending[slot]:
            # PREFILLING: nothing committed under this admission yet; the
            # resume replays the same prompt from the top
            resident = self.slot_filled[slot]
            resume = list(prompt)
            known = prompt[:resident]
        else:
            # DECODING: this admission's prompt and the tokens committed
            # since (``slot_prior`` marks the split, so a second preemption
            # never repeats older outputs).  The last committed token has
            # no KV yet (it is the next step's input): ``known`` stops one
            # short
            resident = self.slot_len[slot]
            resume = list(prompt) + self.outputs[rid][self.slot_prior[slot]:]
            known = resume[:-1]
        if self.prefix is not None and resident:
            # generated-token pages are full pages of real KV too: the
            # resume matches its own history and recomputes only the tail
            self._register_covered(slot, known, resident)
        pages_released = len(self.pool.slot_pages(slot))
        self._release_slot(slot, preempt=True)
        self.slot_rid[slot] = None
        self.slot_len[slot] = 0
        # freeze the abandoned device row in place (a decode graph reads
        # the addresses it was captured with): a done-latched row stops
        # sampling and growing.  Its page-table row is all sentinel after
        # the release, and the pool's two extra pages are what the latch
        # relies on: reads through the sentinel see its never-written zero
        # page, and the row's residual writes land in the never-read sink
        self.done[slot] = True
        self.remaining[slot] = 0
        self.queue.appendleft((rid, resume))
        self._resumed.add(rid)
        self.preempted_rids.add(rid)
        self.metrics.inc("preempt.count")
        self._trace("PREEMPT", rid, slot=slot, reason=reason,
                    pages_held=pages_released, resident_tokens=resident)
        self._submit_t[rid] = time.perf_counter()   # re-open queue wait
        n = self._preempt_counts[rid] = self._preempt_counts.get(rid, 0) + 1
        if n >= max(1, self.cfg.admission_max_skips):
            # an often-preempted request becomes an admission barrier (the
            # skip-ahead aging) and the victim policy protects it
            self._skips[rid] = self.cfg.admission_max_skips
        self.preempt_events.append((self.round, rid, slot, reason))

    def _pick_victim(self) -> int | None:
        """The victim policy over live slots: barrier-protected last, then
        the lowest priority class, most pages mapped, least decode
        progress, lowest slot id.  A chaos override, if armed, replaces
        the policy for this one decision."""
        cands = [i for i, r in enumerate(self.slot_rid) if r is not None]
        if not cands:
            return None
        if self.chaos is not None:
            v = self.chaos.pick_victim(self, list(cands))
            if v is not None:
                return v
        max_skips = max(1, self.cfg.admission_max_skips)

        def key(i: int):
            rid = self.slot_rid[i]
            protected = self._preempt_counts.get(rid, 0) >= max_skips
            progress = (0 if self.slot_pending[i]
                        else len(self.outputs.get(rid, ())))
            return (protected, self.req_priority.get(rid, 0),
                    -len(self.pool.slot_pages(i)), progress, i)
        return min(cands, key=key)

    def _ensure_decode_pages(self, steps: int) -> None:
        """Optimistic admission: before a decode segment, grow every
        decoding slot's table to cover the segment's worst-case advance
        (``steps * (k + 1)`` tokens, capped by the slot's ceiling),
        preempting victims when the pool cannot.  Highest priority grows
        first, so pressure evicts in policy order; a slot picked as its own
        victim stops there (its demand left with it)."""
        if self.pool is None or self.cfg.admission_mode != "optimistic":
            return
        adv = steps * (self._spec_live() + 1)
        order = sorted(
            (i for i, r in enumerate(self.slot_rid)
             if r is not None and not self.slot_pending[i]),
            key=lambda i: (-self.req_priority.get(self.slot_rid[i], 0), i))
        for slot in order:
            if self.slot_rid[slot] is None:
                continue                  # evicted by an earlier growth
            cover = min(self.slot_len[slot] + adv,
                        self.slot_max_tokens[slot])
            need = (self.pool.pages_for(cover)
                    - len(self.pool.slot_pages(slot)))
            if need <= 0:
                continue
            while need > (self.pool.free_pages + self.pool.preempted_pages
                          + self.pool.cached_pages):
                victim = self._pick_victim()
                if victim is None:
                    raise PageError(
                        f"cannot grow slot {slot} by {need} pages: no "
                        "live victim left and the pool cannot cover it")
                self._preempt_slot(victim, reason="pressure")
                if victim == slot:
                    break
            if self.slot_rid[slot] is not None:
                self.pool.extend(slot, need)

    # ------------------------------------------------------------------
    # cancellation, the terminal CANCELLED state (queued, PREFILLING or
    # DECODING), from repro.serve.scheduler
    # ------------------------------------------------------------------
    def cancel(self, rid: int, reason: str = "client") -> bool:
        """Cancel a queued or in-flight request.  A live slot's pages go
        back through ``_release_slot`` (registered prefix pages park
        evictable-cached: their KV is real) and its device row is latched
        done in place, as a preemption's is, minus the re-queue.  False
        when ``rid`` is neither queued nor live."""
        if reason not in CANCEL_REASONS:
            raise ValueError(f"unknown cancel reason {reason!r} "
                             f"(expected one of {CANCEL_REASONS})")
        for qi, (qrid, _) in enumerate(self.queue):
            if qrid == rid:
                del self.queue[qi]
                self._finish_cancel(rid, None, reason)
                return True
        for slot, srid in enumerate(self.slot_rid):
            if srid == rid:
                self._cancel_slot(slot, reason)
                return True
        return False

    def _cancel_slot(self, slot: int, reason: str) -> None:
        rid = self.slot_rid[slot]
        if rid is None:
            raise RuntimeError(f"cancel of empty slot {slot}")
        pages = (len(self.pool.slot_pages(slot))
                 if self.pool is not None else 0)
        if self.prefix is not None and not self.slot_pending[slot]:
            # as a preemption does: full pages of committed KV are real,
            # so the cache keeps what the cancelled request paid for
            out = self.outputs.get(rid, [])
            resume = (list(self.slot_prompt[slot])
                      + out[self.slot_prior[slot]:])
            self._register_covered(slot, resume[:-1] if out else resume,
                                   self.slot_len[slot])
        self._release_slot(slot)
        self.slot_rid[slot] = None
        self.slot_len[slot] = 0
        self.slot_budget[slot] = 0
        # freeze the abandoned device row in place, as ``_preempt_slot``
        # does: a decode graph reads the tensors it was captured with, and
        # the row's sentinel table row keeps its residual reads on the
        # zero page and its writes in the sink
        self.done[slot] = True
        self.remaining[slot] = 0
        self._finish_cancel(rid, slot, reason, pages_released=pages)

    def _finish_cancel(self, rid: int, slot: int | None, reason: str,
                       pages_released: int = 0) -> None:
        """What a queued and a mid-flight cancel share: the reason ledger,
        the counters, deadline scoring (an expiry is a scored miss; shed
        and client cancels are not scored), the RETRY_AFTER rejection of
        a shed, and the CANCEL event."""
        self.cancelled[rid] = reason
        self._resumed.discard(rid)
        self._preempt_counts.pop(rid, None)
        self._skips.pop(rid, None)
        self._submit_t.pop(rid, None)
        dl = self._deadline_t.pop(rid, None)
        self._timeout_t.pop(rid, None)
        self.metrics.inc("cancel.count")
        self.metrics.inc(f"cancel.{reason}")
        if dl is not None and reason in ("deadline", "timeout"):
            self.metrics.inc("deadline.total")
        attrs: dict = {}
        if reason == "shed":
            ra = self.cfg.overload_retry_after_s
            self.rejections.append({"rid": rid, "status": RETRY_AFTER,
                                    "retry_after_s": ra,
                                    "round": self.round})
            attrs["retry_after_s"] = ra
        self._trace("CANCEL", rid, slot=slot, reason=reason,
                    emitted_tokens=len(self.outputs.get(rid, ())),
                    pages_held=pages_released, **attrs)

    def _note_deadline_done(self, rid: int, now: float) -> None:
        """Score a retiring deadline-carrying request: met iff it
        completed at or before its deadline."""
        dl = self._deadline_t.pop(rid, None)
        self._timeout_t.pop(rid, None)
        if dl is None:
            return
        self.metrics.inc("deadline.total")
        if now <= dl:
            self.metrics.inc("deadline.met")

    def _expired(self, rid: int, now: float) -> str | None:
        t = self._timeout_t.get(rid)
        if t is not None and now > t:
            return "timeout"
        d = self._deadline_t.get(rid)
        if d is not None and now > d:
            return "deadline"
        return None

    def _cancel_sweep(self, max_new: int) -> None:
        """Per-round deadline and timeout enforcement: cancel the queued
        and live requests whose stamp passed, and the deadline-carrying
        ones whose remaining budget, at the observed means
        (``project_finish_s``, optimistic), cannot meet the deadline.
        Runs with or without the controller: deadlines belong to the
        request, not to a load policy."""
        if not self._deadline_t and not self._timeout_t:
            return
        now = time.perf_counter()
        for rid, _ in list(self.queue):
            reason = self._expired(rid, now)
            if reason is None and rid in self._deadline_t:
                prior = (len(self.outputs.get(rid, ()))
                         if rid in self._resumed else 0)
                proj = project_finish_s(self.metrics,
                                        max_new - prior, queued=True)
                if (proj is not None
                        and now + proj > self._deadline_t[rid]):
                    reason = "deadline"
            if reason is not None:
                self.cancel(rid, reason)
        for slot, rid in enumerate(self.slot_rid):
            if rid is None:
                continue
            reason = self._expired(rid, now)
            if (reason is None and rid in self._deadline_t
                    and not self.slot_pending[slot]):
                remaining = max(0, self.slot_budget[slot]
                                - len(self.outputs.get(rid, ())))
                proj = project_finish_s(self.metrics, remaining,
                                        queued=False)
                if (proj is not None
                        and now + proj > self._deadline_t[rid]):
                    reason = "deadline"
            if reason is not None:
                self._cancel_slot(slot, reason)

    # ------------------------------------------------------------------
    # the degradation controller and the progress watchdog
    # ------------------------------------------------------------------
    def _overload_round(self) -> None:
        """Feed the controller this round's burn rate and pool pressure,
        trace a transition (DEGRADE), and apply SHEDDING's queue shed; the
        other rungs act where the scheduler reads the speculation window,
        the chunk and the admission sizing."""
        ctl = self.overload
        slo = self.slo_stats()
        burn = max(slo["burn_rate_ttft"], slo["burn_rate_tpot"])
        pressure = self.pool.pressure() if self.pool is not None else 0.0
        prev = ctl.state
        state = ctl.observe(burn=burn, pressure=pressure,
                            queue_depth=len(self.queue), round=self.round)
        if state != prev:
            self.metrics.inc("overload.transitions")
            self._trace("DEGRADE", None, state=state, prev=prev,
                        burn=round(burn, 4), pressure=round(pressure, 4))
        if ctl.shedding:
            self._shed_queued()

    def _shed_queued(self) -> None:
        """SHEDDING's last rung: drain the queue down to
        ``overload_queue_keep`` (None: the slot count), lowest priority
        class first and the latest submitted first within a class, never
        a preempted resume (its work is paid for).  Each shed is answered
        with a RETRY_AFTER rejection."""
        keep = self.cfg.overload_queue_keep
        keep = self.cfg.batch if keep is None else keep
        while len(self.queue) > keep:
            cands = [(qi, rid) for qi, (rid, _) in enumerate(self.queue)
                     if rid not in self._resumed]
            if not cands:
                break
            qi, rid = min(cands, key=lambda c: (
                self.req_priority.get(c[1], 0), -c[0]))
            del self.queue[qi]
            self._finish_cancel(rid, None, "shed")

    def _progress_fingerprint(self) -> tuple:
        """Counters that move with any join, committed token, retirement,
        preemption or cancellation: the watchdog compares them round over
        round."""
        return (self.metrics.count("join.seconds"),
                int(self.metrics.value("preempt.count")),
                int(self.metrics.value("cancel.count")),
                len(self.results),
                sum(len(o) for o in self.outputs.values()))

    def _watchdog_tick(self) -> None:
        """The per-round progress check.  On a trip: dump the flight
        bundle, trace a WATCHDOG instant and force-shed the blocking head,
        so the run finishes minus the shed request instead of looping."""
        if not self.watchdog.tick(self._progress_fingerprint()):
            return
        live = sum(1 for r in self.slot_rid if r is not None)
        err = WatchdogStall(
            f"no scheduler progress for {self.cfg.watchdog_rounds} "
            f"rounds at round {self.round}: queue={len(self.queue)} "
            f"live_slots={live} (livelock/stall — shedding the "
            "blocking head instead of raising)")
        self._dump_flight(err)
        self.metrics.inc("watchdog.trips")
        self._trace("WATCHDOG", None,
                    stalled_rounds=self.cfg.watchdog_rounds,
                    queued=len(self.queue), live_slots=live)
        self._force_shed()

    def _force_shed(self) -> None:
        """Shed what blocks the stalled drain: the queue head when work is
        queued (the request admission cannot place), else the
        lowest-priority live slot (a mid-flight cancel).  Barrier and
        priority protections do not apply."""
        if self.queue:
            rid, _ = self.queue.popleft()
            self._finish_cancel(rid, None, "shed")
            return
        live = [i for i, r in enumerate(self.slot_rid) if r is not None]
        if live:
            slot = min(live, key=lambda i: (
                self.req_priority.get(self.slot_rid[i], 0), i))
            self._cancel_slot(slot, "shed")

    def _write_history(self, writes: list[tuple[int, int, list[int]]]
                       ) -> None:
        """Write ``tokens`` at ``history[slot, start:]`` for each (slot,
        start, tokens) of ``writes``, in place, in one indexed write."""
        if not writes:
            return
        rows = [slot for slot, _, toks in writes for _ in toks]
        cols = [start + j for _, start, toks in writes
                for j in range(len(toks))]
        vals = [t for _, _, toks in writes for t in toks]
        dev = self.history.device
        self.history[torch.tensor(rows, device=dev),
                     torch.tensor(cols, device=dev)] = torch.tensor(
                         vals, dtype=torch.int32, device=dev)

    def _refill(self, max_new: int) -> None:
        """One refill round, as JAX's: the PREFILLING slots' next chunks
        first, then new admissions into free slots (the first chunk of
        each), within ``prefill_round_tokens``; one join prefills every
        piece at its slot's resident depth, and the slots whose prompt it
        completes sample their first token.  The chunk is the one in force
        (``_effective_chunk``); the drafter's history is written whenever
        speculation is configured, shed or not."""
        tr = self.telemetry
        admit = (tr.open("admit", self.round, inner=True)
                 if tr is not None else None)
        chunk = self._effective_chunk()
        round_cap = self.cfg.prefill_round_tokens
        round_used = 0
        # (slot, rid, piece tokens, depth before the piece, commits?)
        take: list[tuple[int, int, list[int], int, bool]] = []
        history: list[tuple[int, int, list[int]]] = []
        # 1. PREFILLING slots: their pages this piece covers are registered
        #    before the admission scan, so queue-mates can match them (the
        #    join writes them before any row reads them)
        for slot, rid in enumerate(self.slot_rid):
            if rid is None or not self.slot_pending[slot]:
                continue
            if round_cap is not None and round_used >= round_cap:
                self.metrics.inc("join.budget_deferrals")
                continue
            pend = self.slot_pending[slot]
            piece = pend[:chunk] if chunk else list(pend)
            depth = self.slot_filled[slot]
            if self.prefix is not None:
                self._register_covered(slot, self.slot_prompt[slot],
                                       depth + len(piece))
            take.append((slot, rid, piece, depth, len(piece) == len(pend)))
            self.metrics.inc("join.chunk_continuations")
            round_used += len(piece)
        # 2. new admissions into free slots
        free = [i for i, r in enumerate(self.slot_rid) if r is None]
        for fi, slot in enumerate(free):
            if not self.queue:
                break
            if round_cap is not None and round_used >= round_cap:
                # every (free slot, queued request) pair left is deferred
                self.metrics.inc("join.budget_deferrals",
                                 min(len(free) - fi, len(self.queue)))
                break
            cand = self._admit_next(slot, max_new)
            if cand is None:
                break
            rid, p, mtoks = cand
            suffix = p[mtoks:]
            piece = suffix[:chunk] if chunk else suffix
            self.slot_prompt[slot] = p
            self.slot_pending[slot] = suffix     # trimmed after the join
            take.append((slot, rid, piece, mtoks,
                         len(piece) == len(suffix)))
            round_used += len(piece)
            if self.history is not None:
                history.append((slot, 0, p))     # the drafter's corpus
        if not take:
            if tr is not None:
                tr.close(admit)
            return
        t0 = time.perf_counter()
        join = None
        if tr is not None:
            tr.close(admit, t1=t0)
            join = tr.open("join", self.round, t0=t0)
            tr.mark(join, "d0")
        b, dev = self.cfg.batch, self.device
        # the join prefills only each row's uncached piece, so its width
        # shrinks with the hit depth and is bounded by the chunk
        width = _pow2_bucket(max(len(piece) for _, _, piece, _, _ in take),
                             lo=8, hi=self.cfg.max_len)
        budgets = []
        for slot, rid, piece, depth, commit in take:
            self.metrics.inc("prefill.computed_tokens", len(piece))
            self._trace("PREFILL_CHUNK", rid, slot=slot, tokens=len(piece),
                        depth=depth, commit=commit,
                        recompute=rid in self._resumed)
            budget = max_new
            if rid in self._resumed:
                # the direct cost of recompute-on-resume
                self.metrics.inc("preempt.recompute_tokens", len(piece))
                # a resume's prompt carries its committed tokens, so its
                # device budget is the rest, or the done latch fires late
                prior = len(self.outputs.get(rid, ()))
                if prior:
                    budget = max(1, max_new - prior)
            budgets.append(budget)

        def up(a):
            return torch.as_tensor(a, device=dev)
        if self.pool is None:
            prompts = np.zeros((len(take), width), np.int32)
            for j, (_, _, piece, _, _) in enumerate(take):
                prompts[j, :len(piece)] = piece
            args = (up(np.asarray([slot for slot, *_ in take])), up(prompts),
                    up(np.asarray([len(piece) for _, _, piece, _, _ in take],
                                  np.int32)),
                    up(np.asarray(budgets, np.int32)), self.gen)
        else:
            join_mask = np.zeros((b,), bool)
            commit_mask = np.zeros((b,), bool)
            prompts = np.zeros((b, width), np.int32)
            plens = np.ones((b,), np.int32)
            prefix_lens = np.zeros((b,), np.int32)
            slot_budgets = np.full((b,), max_new, np.int32)
            for (slot, _, piece, depth, commit), budget in zip(take,
                                                               budgets):
                join_mask[slot] = True
                commit_mask[slot] = commit
                prompts[slot, :len(piece)] = piece
                plens[slot] = len(piece)
                prefix_lens[slot] = depth
                slot_budgets[slot] = budget
            args = (up(join_mask), up(prompts), up(plens), up(slot_budgets),
                    self.gen, up(self.pool.table), up(prefix_lens),
                    up(commit_mask))
        # traced, the model's parts record into the join (parthook)
        with parthook.armed(tr.part) if tr is not None else parthook.NULL:
            *_, first = self._join(self.params, self.caches, self.tok,
                                   self.lengths, self.done, self.remaining,
                                   *args)
        if tr is not None:
            tr.mark(join, "d1")
        first = first.cpu().numpy()
        if tr is not None:
            tr.device_sync()
        if self.pool is None:       # the dense join's are the joining rows'
            first = dict(zip((slot for slot, *_ in take), first.tolist()))
        now = time.perf_counter()
        self.joins += 1
        for slot, rid, piece, depth, commit in take:
            if self.slot_rid[slot] is None:       # a new admission
                # cached-prefix tokens the join did not compute
                self.metrics.inc("prefill.skipped_tokens", depth)
            self.slot_filled[slot] = depth + len(piece)
            self.slot_pending[slot] = self.slot_pending[slot][len(piece):]
            self.slot_len[slot] = self.slot_filled[slot]
            if not commit:
                self.slot_rid[slot] = rid         # PREFILLING: occupied,
                self.slot_budget[slot] = max_new  # frozen on the device
                continue
            tokv = int(first[slot])
            prev = self.outputs.get(rid) if rid in self._resumed else None
            # committed tokens that predate this admission: a later
            # preemption resumes from slot_prompt + outputs[prior:]
            self.slot_prior[slot] = len(prev) if prev is not None else 0
            if prev is not None:
                prev.append(tokv)                 # a resume keeps its
                out = prev                        # earlier outputs
            else:
                out = [tokv]
                self.outputs[rid] = out
            # a resumed request keeps its first-token stamp
            if self._clock0 is not None and rid not in self._first_tok_t:
                self._first_tok_t[rid] = now
                self.metrics.observe("lat.ttft_s", now - self._clock0)
                self._slo_observe("ttft", rid, now - self._clock0)
                self._trace("FIRST_TOKEN", rid, slot=slot, token=tokv,
                            ttft_s=now - self._clock0)
            if self.history is not None:
                # the current token, on which the first verify's tail
                # n-gram ends
                history.append((slot, self.slot_filled[slot], [tokv]))
            if (self.eos is not None and tokv == self.eos) \
                    or len(out) >= max_new:
                self._retire(slot, rid, out, now)     # retired at commit
            else:
                self.slot_rid[slot] = rid
                self.slot_budget[slot] = max_new
        if self.history is not None:
            self._write_history(history)
        t1 = time.perf_counter()
        self.metrics.observe("join.seconds", t1 - t0)
        if tr is not None:
            # B rows computed at width W, whoever joins
            tr.close(join, t1=t1, rows=b, width=width, joined=len(take),
                     real_tokens=sum(len(p) for _, _, p, _, _ in take),
                     committed=sum(c for *_, c in take))

    def _collect(self, emitted: np.ndarray) -> None:
        """Drain one segment's emitted block into per-request outputs,
        with the device's retirement rules.  The plain loop emits [steps,
        B]; the speculative one [steps, B, k+1], each step a burst of 1 to
        k+1 committed tokens ended by PAD (a PAD ends the step's burst,
        not the slot), whose lengths feed ``spec_stats``.  PREFILLING
        slots emit only PAD and are skipped.  A plain segment of a
        speculating batcher (the controller shed speculation) writes its
        committed tokens into the drafter's history here, where the
        verify loop writes its own, so a re-enabled drafter reads them.
        Returns the tokens it appended."""
        if emitted.ndim == 2:
            emitted = emitted[:, :, None]
        steps, _, width = emitted.shape
        now = time.perf_counter()
        mirror = self.history is not None and width == 1
        history: list[tuple[int, int, list[int]]] = []
        total = 0
        for i, rid in enumerate(self.slot_rid):
            if rid is None or self.slot_pending[i]:
                continue
            out = self.outputs[rid]
            appended = 0
            for t in range(steps):
                burst = 0
                for j in range(width):
                    v = int(emitted[t, i, j])
                    if v == PAD_TOKEN:
                        break
                    out.append(v)
                    burst += 1
                    appended += 1
                    self.slot_len[i] += 1
                    if mirror and self.slot_len[i] < self.cfg.max_len:
                        # the verify loop's position: the token at the
                        # length after it
                        history.append((i, self.slot_len[i], [v]))
                    if ((self.eos is not None and v == self.eos)
                            or len(out) >= self.slot_budget[i]):
                        self._retire(i, rid, out, now)
                        break
                if self.spec_k and width > 1 and burst:
                    # one verify step: burst - 1 accepted drafts and the
                    # model's bonus token
                    self.metrics.inc("spec.steps")
                    self.metrics.inc("spec.proposed", self.spec_k)
                    self.metrics.inc("spec.accepted", burst - 1)
                    self.metrics.inc("spec.emitted", burst)
                    self._trace("SPEC_COMMIT", rid, slot=i, step=t,
                                committed=burst, accepted_drafts=burst - 1,
                                proposed=self.spec_k)
                if self.slot_rid[i] is None or burst == 0:
                    # retired, or the device's done latch fired: every
                    # later step of the segment is PAD
                    break
            if appended == 0 and self.slot_rid[i] is not None:
                raise RuntimeError(
                    f"slot {i} (request {rid}) stalled: device reports done "
                    "but host bookkeeping thinks it is live")
            total += appended
        self._write_history(history)
        return total

    def _decode_segment(self, steps: int) -> torch.Tensor:
        """Run one decode segment of ``steps`` steps over the live slots,
        bounded by the page cap (paged) or ``_kv_cap`` (dense); returns the
        emitted tokens, [steps, B] ([steps, B, k+1] speculating), on the
        device.  Paged, the bucket's persistent slice of the page table is
        refilled from the host's table first (``copy_``): a graph reads
        the address it was captured with."""
        if self.pool is not None:
            cap = self._page_cap()
            pages = self._pages.get(cap)
            if pages is None:
                pages = self._pages[cap] = torch.empty(
                    (self.cfg.batch, cap), dtype=torch.int32,
                    device=self.device)
            pages.copy_(torch.from_numpy(
                np.ascontiguousarray(self.pool.table[:, :cap])))
            extra = ((self.history, pages) if self._spec_live()
                     else (pages,))
        else:
            cap = self._kv_cap(steps)
            extra = ()
        emitted = self._loop(steps, cap)(
            self.params, self.tok, self.caches, self.lengths, self.done,
            self.remaining, self.gen, *extra)
        self.segments += 1
        self.spec_segments += len(extra) == 2
        return emitted

    def run(self, max_new: int = 16) -> dict[int, list[int]]:
        """Drain the queue.  Each scheduling round (``round``), in JAX's
        order: the chaos injector, the degradation controller, the
        deadline sweep and the watchdog act at its top (a chaos stall
        ends the round there); then the round refills slots, grows the
        optimistic slots' tables, runs one decode segment and reads the
        emitted tokens back.  No segment runs while every live slot is
        PREFILLING: the next round takes their next chunks.  A
        ``PageError`` dumps the flight bundle before it propagates."""
        if max_new <= 0:
            while self.queue:
                rid, _ = self.queue.popleft()
                self.results[rid] = []
            return self.results
        if self._clock0 is None:
            self._clock0 = time.perf_counter()
        # the speculation window counts toward the worst case: a verify
        # writes K/V (and needs table width) up to lengths + speculate_k
        window = self.spec_k
        for rid, prompt in self.queue:
            if rid in self._resumed:
                # a resume's prompt holds committed tokens; it was checked
                # at its first admission, and its total never grows
                continue
            if len(prompt) + max_new + window > self.cfg.max_len:
                raise ValueError(
                    f"request {rid}: prompt {len(prompt)} + max_new "
                    f"{max_new}"
                    + (f" + speculation window {window}" if window else "")
                    + f" exceeds max_len {self.cfg.max_len}")
            if self.pool is None:
                continue
            need = self.pool.pages_for(len(prompt) + max_new + window)
            if need > min(self.pool.n_pages, self.pool.max_pages):
                raise ValueError(
                    f"request {rid}: needs {need} pages, pool holds "
                    f"{self.pool.n_pages} (max {self.pool.max_pages}/slot)")
        steps = max(1, self.cfg.sync_every)
        self._max_new = max_new
        try:
            while self.queue or any(r is not None for r in self.slot_rid):
                self._round(max_new, steps)
        except PageError as err:
            # the postmortem before the error propagates: the ring's last
            # events, the allocator and the slot table
            self._dump_flight(err)
            raise
        if self.chaos is not None:
            self.chaos.on_drain(self)
        return self.results

    def _round(self, max_new: int, steps: int) -> None:
        """One scheduling round of ``run`` (traced: in its ``round``
        span)."""
        self.round += 1
        tr = self.telemetry
        if tr is None:
            self._round_body(max_new, steps, None)
            return
        with tr.round_span(self.round):
            self._round_body(max_new, steps, tr)

    def _round_body(self, max_new: int, steps: int, tr: Tracer | None
                    ) -> None:
        if self.chaos is not None:
            if tr is not None:
                with tr.span("chaos", self.round):
                    self.chaos.on_round(self)
            else:
                self.chaos.on_round(self)
        with (tr.inner_span("sweep", self.round) if tr is not None
              else parthook.NULL):
            if self.overload is not None:
                self._overload_round()
            self._cancel_sweep(max_new)
            # any stall (an admission that can never place, a chaos stall)
            # trips the watchdog after ``watchdog_rounds`` rounds without
            # progress: it dumps the flight bundle and sheds the blocking
            # head
            self._watchdog_tick()
        if self.round < self._stall_until:
            return                               # a chaos stall: dead round
        self._refill(max_new)
        if not any(r is not None and not self.slot_pending[i]
                   for i, r in enumerate(self.slot_rid)):
            return
        # optimistic: cover the segment's advance, preempting on pressure;
        # that may evict every decoding slot (a chaos hold), and then the
        # next round re-admits from the queue
        self._ensure_decode_pages(steps)
        if not any(r is not None and not self.slot_pending[i]
                   for i, r in enumerate(self.slot_rid)):
            return
        self._sample_kv()
        if tr is None:
            self._collect(self._decode_segment(steps).cpu().numpy())
            return
        # traced: the span runs from the launch to the emitted tokens'
        # read-back, the segment's one host sync, as untraced
        live = [i for i, r in enumerate(self.slot_rid)
                if r is not None and not self.slot_pending[i]]
        kv = self._kv_read(live, steps)
        seg = tr.open("decode-segment", self.round, t0=time.perf_counter())
        tr.mark(seg, "d0")
        emitted = self._decode_segment(steps)
        tr.mark(seg, "d1")
        emitted = emitted.cpu().numpy()
        tr.close(seg, t1=time.perf_counter(), steps=steps,
                 live_rows=len(live), kv_tokens=kv)
        tr.device_sync()
        with tr.span("collect", self.round):
            seg["tokens"] = self._collect(emitted)

    def _kv_read(self, live: list[int], steps: int) -> int:
        """Keys the live rows read over a plain segment of ``steps``: a
        row of ``slot_len`` L reads L + j + 1 at step j, for the steps its
        budget and ``max_len`` leave it (a verify step reads k more)."""
        total = 0
        for i in live:
            n = min(steps, self.cfg.max_len - self.slot_len[i],
                    self.slot_budget[i] - len(self.outputs[self.slot_rid[i]]))
            n = max(0, n)
            total += n * self.slot_len[i] + n * (n + 1) // 2
        return total

    # ------------------------------------------------------------------
    # flight recorder
    # ------------------------------------------------------------------
    def _dump_flight(self, err: BaseException) -> dict | None:
        """Assemble (and, when ``cfg.flight_path`` or $REPRO_FLIGHT_PATH
        names a file, write as JSON) the flight recorder's bundle: the
        ring's last events, the pool's snapshot, the host slot table, the
        queue, the config and the metrics at the moment of ``err``.  Kept
        as ``last_flight_bundle``."""
        if self.flight is None:
            return None
        cfg = {k: (v if isinstance(v, (bool, int, float, str, type(None)))
                   else str(v))
               for k, v in dataclasses.asdict(self.cfg).items()}
        bundle = {
            "schema": 1,
            "error": f"{type(err).__name__}: {err}",
            "round": self.round,
            "config": cfg,
            "events": self.flight.tail(),
            "slot_table": {
                "slot_rid": list(self.slot_rid),
                "slot_len": list(self.slot_len),
                "slot_filled": list(self.slot_filled),
                "slot_budget": list(self.slot_budget),
                "slot_prior": list(self.slot_prior),
                "slot_max_tokens": list(self.slot_max_tokens),
                "pending_tokens": [len(p) for p in self.slot_pending]},
            "pool": self.pool.snapshot() if self.pool is not None else None,
            "queue": [[rid, len(p)] for rid, p in self.queue],
            "preempt_events": list(self.preempt_events),
            "metrics": self.metrics.snapshot(),
        }
        self.last_flight_bundle = bundle
        path = self.cfg.flight_path or os.environ.get("REPRO_FLIGHT_PATH")
        if path:
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1)
                f.write("\n")
        return bundle

    # ------------------------------------------------------------------
    # accounting, from repro.serve.scheduler (the same keys)
    # ------------------------------------------------------------------
    def _sample_kv(self) -> None:
        """Record (live tokens, allocated token capacity, live slots) at a
        segment boundary.  Dense allocates ``batch * max_len`` whether or
        not slots are live; paged allocates only the mapped pages."""
        live = [i for i, r in enumerate(self.slot_rid) if r is not None]
        live_tokens = sum(self.slot_len[i] for i in live)
        if self.pool is not None:
            alloc = self.pool.used_pages * self.pool.page_size
        else:
            alloc = self.cfg.batch * self.cfg.max_len
        self.kv_samples.append((live_tokens, alloc, len(live)))

    def kv_utilization(self) -> dict:
        """Mean and peak KV utilization (live tokens / allocated token
        capacity) over the segments' samples, and the peak of live
        slots."""
        if not self.kv_samples:
            return {"mean_util": 0.0, "peak_util": 0.0,
                    "peak_live_slots": 0, "samples": 0}
        utils = [lt / cap for lt, cap, _ in self.kv_samples if cap]
        return {"mean_util": sum(utils) / max(1, len(utils)),
                "peak_util": max(utils, default=0.0),
                "peak_live_slots": max(s for _, _, s in self.kv_samples),
                "samples": len(self.kv_samples)}

    def join_stats(self) -> dict:
        """Join latency: every join stalls the live slots' decode for its
        duration, which chunked prefill bounds.  ``chunk_joins`` counts
        the continuation pieces (0 unchunked), ``budget_deferrals`` the
        pieces ``prefill_round_tokens`` pushed to a later round (0
        uncapped)."""
        m = self.metrics
        n = m.count("join.seconds")
        return {"joins": n,
                "chunk_joins": int(m.value("join.chunk_continuations")),
                "budget_deferrals": int(m.value("join.budget_deferrals")),
                "max_join_s": max(m.samples("join.seconds"), default=0.0),
                "mean_join_s": m.sum("join.seconds") / n if n else 0.0}

    def reset_stats(self) -> None:
        """Zero the per-wave measurement state, so that a wave re-submitted
        into a warm batcher (its graphs captured) is measured alone: the
        registry's counters (prefill, prefix, chunk and speculation ones
        among them) and histograms, the run clock, the first-token stamps,
        the KV samples, the preemption events, the cancellations and
        rejections, and the controller's time in state and transitions.
        Operational state stays:
        the slot table, the queued requests' submit stamps and skips, the
        in-flight ``_resumed`` and ``_preempt_counts``, the admission
        order, the prefix cache's contents, the captured graphs, the round
        counter, ``joins`` and ``segments``, the deadline stamps and the
        degradation controller's rung."""
        self._clock0 = None
        self._first_tok_t.clear()
        self.metrics.reset()
        # the pool-partition gauges describe the live pool: clear them and
        # seed them again from it
        self.metrics.clear_gauges("pool.")
        if self.pool is not None and self.pool.gauge_cb is not None:
            self.pool._notify()
        self._slo_classes.clear()
        self.kv_samples = []
        self.preempt_events.clear()
        self.preempted_rids.clear()
        self.cancelled.clear()
        self.rejections.clear()
        if self.overload is not None:
            self.overload.reset()

    def prefix_stats(self) -> dict:
        """Prefix-cache effectiveness: prefill tokens computed and skipped
        (token hit rate), request hits and the cache's residency.  With
        the cache off every token is computed and the rates read 0."""
        total = self.prefill_computed + self.prefill_skipped
        return {"enabled": self.prefix is not None,
                "prefill_computed": self.prefill_computed,
                "prefill_skipped": self.prefill_skipped,
                "hit_rate": self.prefill_skipped / total if total else 0.0,
                "admits": self.prefix_admits,
                "hits": self.prefix_hits,
                "cached_pages": (self.pool.cached_pages
                                 if self.pool is not None else 0),
                "radix_entries": (self.prefix.n_entries
                                  if self.prefix is not None else 0),
                "evicted_pages": (self.prefix.evicted_pages
                                  if self.prefix is not None else 0)}

    def spec_stats(self) -> dict:
        """Self-speculation: ``acceptance_rate`` = accepted drafts /
        proposed drafts, ``tokens_per_step`` = committed tokens a verify
        step (1.0: no draft ever accepted, k+1: every one).  Zeros with
        speculation off."""
        m = self.metrics
        steps = int(m.value("spec.steps"))
        proposed = int(m.value("spec.proposed"))
        accepted = int(m.value("spec.accepted"))
        emitted = int(m.value("spec.emitted"))
        return {"enabled": bool(self.spec_k),
                "k": self.spec_k,
                "steps": steps,
                "proposed": proposed,
                "accepted": accepted,
                "acceptance_rate": (accepted / proposed
                                    if proposed else 0.0),
                "tokens_per_step": (emitted / steps
                                    if steps else 0.0)}

    def latency_stats(self) -> dict:
        """Per-request latency observed at host sync points: time to first
        token (run start to the join that sampled it), time per output
        token ((retirement - first token) / (tokens - 1), requests of more
        than one token) and queue wait (submit to admission).  Segment
        syncs quantize them: serving-level numbers, not kernel timings.  A
        preempted request observes one queue wait per admission.  The
        preemption, cancellation, shed, deadline and watchdog counters ride
        along, so one dict says what the latencies paid for; deadline
        attainment is 1.0 with no deadline scored."""
        m = self.metrics
        return {"requests": m.count("lat.ttft_s"),
                "ttft_p50_s": m.percentile("lat.ttft_s", 50),
                "ttft_p95_s": m.percentile("lat.ttft_s", 95),
                "tpot_p50_s": m.percentile("lat.tpot_s", 50),
                "tpot_p95_s": m.percentile("lat.tpot_s", 95),
                "queue_wait_p50_s": m.percentile("lat.queue_wait_s", 50),
                "queue_wait_p95_s": m.percentile("lat.queue_wait_s", 95),
                "preemptions": int(m.value("preempt.count")),
                "preempted_token_recompute":
                    int(m.value("preempt.recompute_tokens")),
                "cancellations": int(m.value("cancel.count")),
                "shed_requests": int(m.value("cancel.shed")),
                "deadline_met": int(m.value("deadline.met")),
                "deadline_total": int(m.value("deadline.total")),
                "deadline_attainment": self._deadline_attainment(),
                "watchdog_trips": int(m.value("watchdog.trips"))}

    def _deadline_attainment(self) -> float:
        """Met over the scored deadline-carrying requests (retired: met
        iff on time; cancelled for deadline or timeout: missed); 1.0 with
        none."""
        total = int(self.metrics.value("deadline.total"))
        met = int(self.metrics.value("deadline.met"))
        return met / total if total else 1.0

    def overload_stats(self) -> dict:
        """Cancellations by reason, sheds, deadline attainment, watchdog
        trips, the RETRY_AFTER rejections and the controller's state
        machine (state, time in state, transitions, recovery).  With the
        controller off it reads HEALTHY with no time in state."""
        m = self.metrics
        if self.overload is not None:
            ctl = self.overload.stats()
        else:
            ctl = {"state": HEALTHY, "recovered_to_healthy": False,
                   "transitions": [],
                   "time_in_state": {s: 0.0 for s in STATES}}
        return {"enabled": self.overload is not None,
                "cancellations": int(m.value("cancel.count")),
                "cancelled_by_reason": {
                    r: int(m.value(f"cancel.{r}")) for r in CANCEL_REASONS},
                "shed_requests": int(m.value("cancel.shed")),
                "deadline_met": int(m.value("deadline.met")),
                "deadline_total": int(m.value("deadline.total")),
                "deadline_attainment": self._deadline_attainment(),
                "watchdog_trips": int(m.value("watchdog.trips")),
                "rejections": list(self.rejections),
                "controller": ctl}

    def slo_stats(self, window: int = 64) -> dict:
        """SLO attainment and burn rate against ``cfg.ttft_slo_s`` and
        ``cfg.tpot_slo_s``: ``slo_attainment``, met over total across both
        metrics and every priority class (1.0 with no SLO or no sample);
        ``classes``, met/total/attainment per priority class; and
        ``burn_rate_*``, the violating share of the last ``window``
        samples over the error budget ``1 - slo_target`` (1.0 burns
        exactly the budget)."""
        cfg, m = self.cfg, self.metrics
        enabled = (cfg.ttft_slo_s is not None
                   or cfg.tpot_slo_s is not None)
        classes: dict[int, dict] = {}
        met_all = total_all = 0
        for cls in sorted(self._slo_classes):
            row: dict = {}
            for metric in ("ttft", "tpot"):
                tot = int(m.value(f"slo.{metric}_total.c{cls}"))
                met = int(m.value(f"slo.{metric}_met.c{cls}"))
                row[f"{metric}_met"] = met
                row[f"{metric}_total"] = tot
                row[f"{metric}_attainment"] = met / tot if tot else 1.0
                met_all += met
                total_all += tot
            classes[cls] = row
        budget = max(1e-9, 1.0 - cfg.slo_target)
        burn = {}
        for metric, slo in (("ttft", cfg.ttft_slo_s),
                            ("tpot", cfg.tpot_slo_s)):
            if slo is None:
                burn[metric] = 0.0
                continue
            recent = m.samples(f"lat.{metric}_s")[-window:]
            viol = (sum(1 for v in recent if v > slo) / len(recent)
                    if recent else 0.0)
            burn[metric] = viol / budget
        return {"enabled": enabled,
                "ttft_slo_s": cfg.ttft_slo_s,
                "tpot_slo_s": cfg.tpot_slo_s,
                "slo_target": cfg.slo_target,
                "slo_attainment": (met_all / total_all
                                   if total_all else 1.0),
                "classes": classes,
                "window": window,
                "burn_rate_ttft": burn["ttft"],
                "burn_rate_tpot": burn["tpot"]}

    def preempt_stats(self) -> dict:
        """Preemptions, the requests preempted, the prefill tokens spent
        resuming them, chaos slot failures, the events (round, rid, slot,
        reason), and ``recomputed_ok``: every request ever preempted has
        retired with a result or was cancelled (True with no
        preemption)."""
        ok = all((rid in self.results or rid in self.cancelled)
                 and rid not in self._resumed
                 for rid in self.preempted_rids)
        return {"enabled": self.cfg.admission_mode == "optimistic",
                "preemptions": self.preemptions,
                "preempted_requests": len(self.preempted_rids),
                "recompute_tokens": self.preempted_token_recompute,
                "slot_failures": (self.chaos.slot_failures
                                  if self.chaos is not None else 0),
                "recomputed_ok": ok,
                "events": list(self.preempt_events)}


Batcher = ContinuousBatcher
