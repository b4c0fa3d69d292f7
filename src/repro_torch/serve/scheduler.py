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
  admission); rows outside the join write nothing to live pages; a retired
  slot's pages go back to the pool at the segment boundary.  Each segment
  slices the page table to a power-of-two bound on the deepest live slot's
  page count (page-cap bucketing).

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

Accounting, at the host sync points as in JAX: time to first token (run
start to the join that sampled it), time per output token, queue wait and
join seconds go into a :class:`~repro_torch.serve.telemetry.
MetricsRegistry` (``latency_stats``, ``join_stats``); KV use is sampled
once a segment (``kv_utilization``); ``reset_stats`` clears them between
waves.

Not yet ported (later slices): the prefix cache, chunked prefill,
speculation, optimistic admission with preemption, cancellation,
deadlines, the watchdog and overload control, tracing and attribution.
Their counters read 0 in the stats, as they do in JAX with them off.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .engine import (PAD_TOKEN, GraphedLoop, ServeConfig, make_decode_loop,
                     make_join, make_paged_join)
from .kvpool import KVPool
from .telemetry import MetricsRegistry
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
    tools); True on the CPU raises."""

    def __init__(self, model: Model, params, cfg: ServeConfig,
                 eos_id: int | None = None, seed: int = 0,
                 graphs: bool | None = None):
        self.model, self.params, self.cfg = model, params, cfg
        self.eos = eos_id
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
        b = cfg.batch
        if cfg.paged:
            self.pool = KVPool(cfg.pool_pages, cfg.page_size, b,
                               max_pages=cfg.max_pages)
            self.caches = model.init_paged_caches(
                b, cfg.pool_pages, cfg.page_size, cfg.dtype, device=dev)
            self._join = make_paged_join(model, cfg, eos_id=eos_id)
        else:
            self.pool = None
            self.caches = model.init_caches(b, cfg.max_len, cfg.dtype,
                                            device=dev)
            self._join = make_join(model, cfg, eos_id=eos_id)
        # decode loops by (steps, kv_cap) (dense) or (steps, P_cap)
        # (paged): the eager loop, or its graph
        self._loops: dict[tuple[int, int | None], object] = {}
        self._pages: dict[int, torch.Tensor] = {}   # P_cap -> [B, P_cap]
        self.tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.done = torch.ones((b,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.queue: collections.deque[tuple[int, list[int]]] = \
            collections.deque()
        self.results: dict[int, list[int]] = {}
        self.outputs: dict[int, list[int]] = {}
        # host mirror of the slot table
        self.slot_rid: list[int | None] = [None] * b
        self.slot_budget = [0] * b
        self.slot_len = [0] * b          # tokens in each slot's cache
        self.admit_order: list[int] = []
        # skip-ahead aging: times each queued rid has been bypassed
        self._skips: dict[int, int] = {}
        # joins and decode segments over the batcher's life (reset_stats
        # keeps them: the chip tools' launch checks read them)
        self.joins = 0
        self.segments = 0
        # every per-wave stat lives in the registry; KV use is sampled
        # once a segment as (live tokens, allocated token capacity, live
        # slots)
        self.metrics = MetricsRegistry()
        self.kv_samples: list[tuple[int, int, int]] = []
        self._clock0: float | None = None
        self._first_tok_t: dict[int, float] = {}
        self._submit_t: dict[int, float] = {}

    def submit(self, rid: int, prompt: list[int]) -> None:
        if not prompt:
            raise ValueError("empty prompt")
        self.queue.append((rid, list(prompt)))
        self._submit_t[rid] = time.perf_counter()

    def _loop(self, steps: int, cap: int | None = None):
        """The decode loop of ``(steps, cap)``: ``cap`` is ``kv_cap`` on
        the dense path and the page table slice's width on the paged one.
        With graphs, the bucket's :class:`GraphedLoop`."""
        key = (steps, cap)
        if key not in self._loops:
            loop = make_decode_loop(
                self.model, self.cfg, steps=steps, eos_id=self.eos,
                kv_cap=None if self.cfg.paged else cap,
                paged=self.cfg.paged)
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
        count (allocation covers prompt + budget, so a segment can never
        outgrow it)."""
        live = [len(self.pool.slot_pages(i))
                for i, r in enumerate(self.slot_rid) if r is not None]
        if not live:
            return self.cfg.max_pages
        return _pow2_bucket(max(live), lo=2, hi=self.cfg.max_pages)

    def _note_admitted(self, rid: int) -> None:
        """Close the request's queue-wait interval (opened at submit)."""
        t0 = self._submit_t.pop(rid, None)
        if t0 is not None:
            self.metrics.observe("lat.queue_wait_s",
                                 time.perf_counter() - t0)

    def _admit_next(self, slot: int, max_new: int):
        """Pop and reserve the next admissible queued request for
        ``slot``: ``(rid, prompt)`` or None.  Dense, the queue head (a
        free slot is enough).  Paged, a request whose worst case (prompt +
        budget) the pool can hold, which is then reserved: FIFO takes the
        head or nothing; skip-ahead scans a window of
        ``admission_lookahead`` requests, charges each one it passes a
        skip, and never passes one whose skips reached
        ``admission_max_skips``."""
        if not self.queue:
            return None
        if self.pool is None:
            rid, p = self.queue.popleft()
            self.admit_order.append(rid)
            self._note_admitted(rid)
            return rid, p
        window = 1
        if self.cfg.admission == "skip-ahead":
            window = min(len(self.queue), self.cfg.admission_lookahead)
        for qi in range(window):
            rid, p = self.queue[qi]
            if not self.pool.can_admit(len(p) + max_new):
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
            self.pool.reserve(slot, len(p) + max_new)
            return rid, p
        return None

    def _retire(self, slot: int, rid: int, out: list[int],
                now: float) -> None:
        """Retire ``rid`` from ``slot`` at host time ``now``, observing its
        time per output token (requests of more than one token)."""
        self.results[rid] = out
        self.slot_rid[slot] = None
        if self.pool is not None:
            self.pool.release(slot)
        if (self._clock0 is not None and len(out) > 1
                and rid in self._first_tok_t):
            tpot = (now - self._first_tok_t[rid]) / (len(out) - 1)
            if tpot > 0.0:
                self.metrics.observe("lat.tpot_s", tpot)

    def _refill(self, max_new: int) -> None:
        take: list[tuple[int, int, list[int]]] = []
        for slot in range(self.cfg.batch):
            if self.slot_rid[slot] is not None:
                continue
            cand = self._admit_next(slot, max_new)
            if cand is None:
                break
            take.append((slot,) + cand)
        if not take:
            return
        t0 = time.perf_counter()
        b, dev = self.cfg.batch, self.device
        width = _pow2_bucket(max(len(p) for _, _, p in take), lo=8,
                             hi=self.cfg.max_len)

        def up(a):
            return torch.as_tensor(a, device=dev)
        if self.pool is None:
            prompts = np.zeros((len(take), width), np.int32)
            for j, (_, _, p) in enumerate(take):
                prompts[j, :len(p)] = p
            *_, first = self._join(
                self.params, self.caches, self.tok, self.lengths, self.done,
                self.remaining, up(np.asarray([slot for slot, _, _ in take])),
                up(prompts),
                up(np.asarray([len(p) for _, _, p in take], np.int32)),
                up(np.full((len(take),), max_new, np.int32)), self.gen)
            first = dict(zip((slot for slot, _, _ in take),
                             first.cpu().numpy().tolist()))
        else:
            join_mask = np.zeros((b,), bool)
            prompts = np.zeros((b, width), np.int32)
            plens = np.ones((b,), np.int32)
            for slot, _, p in take:
                join_mask[slot] = True
                prompts[slot, :len(p)] = p
                plens[slot] = len(p)
            mask_t = up(join_mask)
            *_, first = self._join(
                self.params, self.caches, self.tok, self.lengths, self.done,
                self.remaining, mask_t, up(prompts), up(plens),
                up(np.full((b,), max_new, np.int32)), self.gen,
                up(self.pool.table), up(np.zeros((b,), np.int32)), mask_t)
            first = first.cpu().numpy()
        now = time.perf_counter()
        self.joins += 1
        for slot, rid, p in take:
            tokv = int(first[slot])
            out = [tokv]
            self.outputs[rid] = out
            self.slot_len[slot] = len(p)
            if self._clock0 is not None and rid not in self._first_tok_t:
                self._first_tok_t[rid] = now
                self.metrics.observe("lat.ttft_s", now - self._clock0)
            if (self.eos is not None and tokv == self.eos) or max_new <= 1:
                self._retire(slot, rid, out, now)     # retired at commit
            else:
                self.slot_rid[slot] = rid
                self.slot_budget[slot] = max_new
        self.metrics.observe("join.seconds", time.perf_counter() - t0)

    def _collect(self, emitted: np.ndarray) -> None:
        """Drain one segment's emitted block [steps, B] into per-request
        outputs, with the device's retirement rules."""
        now = time.perf_counter()
        for i, rid in enumerate(self.slot_rid):
            if rid is None:
                continue
            out = self.outputs[rid]
            appended = 0
            for t in range(emitted.shape[0]):
                v = int(emitted[t, i])
                if v == PAD_TOKEN:
                    break
                out.append(v)
                appended += 1
                self.slot_len[i] += 1
                if ((self.eos is not None and v == self.eos)
                        or len(out) >= self.slot_budget[i]):
                    self._retire(i, rid, out, now)
                    break
            if appended == 0 and self.slot_rid[i] is not None:
                raise RuntimeError(
                    f"slot {i} (request {rid}) stalled: device reports done "
                    "but host bookkeeping thinks it is live")

    def _decode_segment(self, steps: int) -> torch.Tensor:
        """Run one decode segment of ``steps`` steps over the live slots,
        bounded by the page cap (paged) or ``_kv_cap`` (dense); returns the
        emitted tokens [steps, B] on the device.  Paged, the bucket's
        persistent slice of the page table is refilled from the host's
        table first (``copy_``): a graph reads the address it was captured
        with."""
        if self.pool is not None:
            cap = self._page_cap()
            pages = self._pages.get(cap)
            if pages is None:
                pages = self._pages[cap] = torch.empty(
                    (self.cfg.batch, cap), dtype=torch.int32,
                    device=self.device)
            pages.copy_(torch.from_numpy(
                np.ascontiguousarray(self.pool.table[:, :cap])))
            extra = (pages,)
        else:
            cap = self._kv_cap(steps)
            extra = ()
        emitted = self._loop(steps, cap)(
            self.params, self.tok, self.caches, self.lengths, self.done,
            self.remaining, self.gen, *extra)
        self.segments += 1
        return emitted

    def run(self, max_new: int = 16) -> dict[int, list[int]]:
        """Drain the queue: refill slots, run decode segments, read the
        emitted tokens back once per segment."""
        if max_new <= 0:
            while self.queue:
                rid, _ = self.queue.popleft()
                self.results[rid] = []
            return self.results
        if self._clock0 is None:
            self._clock0 = time.perf_counter()
        for rid, prompt in self.queue:
            if len(prompt) + max_new > self.cfg.max_len:
                raise ValueError(
                    f"request {rid}: prompt {len(prompt)} + max_new "
                    f"{max_new} exceeds max_len {self.cfg.max_len}")
            if self.pool is not None and (
                    self.pool.pages_for(len(prompt) + max_new)
                    > min(self.pool.n_pages, self.pool.max_pages)):
                raise ValueError(
                    f"request {rid}: needs "
                    f"{self.pool.pages_for(len(prompt) + max_new)} pages, "
                    f"pool holds {self.pool.n_pages} "
                    f"(max {self.pool.max_pages}/slot)")
        steps = max(1, self.cfg.sync_every)
        while self.queue or any(r is not None for r in self.slot_rid):
            self._refill(max_new)
            if not any(r is not None for r in self.slot_rid):
                continue
            self._sample_kv()
            self._collect(self._decode_segment(steps).cpu().numpy())
        return self.results

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
        duration.  ``chunk_joins`` and ``budget_deferrals`` read 0:
        chunked prefill is not ported."""
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
        registry's counters and histograms, the run clock, the first-token
        stamps and the KV samples.  Operational state stays: the slot
        table, the queued requests' submit stamps and skips, the admission
        order, the captured graphs, and ``joins`` and ``segments``."""
        self._clock0 = None
        self._first_tok_t.clear()
        self.metrics.reset()
        self.kv_samples = []

    def latency_stats(self) -> dict:
        """Per-request latency observed at host sync points: time to first
        token (run start to the join that sampled it), time per output
        token ((retirement - first token) / (tokens - 1), requests of more
        than one token) and queue wait (submit to admission).  Segment
        syncs quantize them: serving-level numbers, not kernel timings.
        The preemption, cancellation, deadline and watchdog counters read
        0 (those features are not ported) and deadline attainment 1.0, as
        JAX gives with them off."""
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
        """Met over scored deadline-carrying requests; 1.0 with none."""
        total = int(self.metrics.value("deadline.total"))
        met = int(self.metrics.value("deadline.met"))
        return met / total if total else 1.0


Batcher = ContinuousBatcher
