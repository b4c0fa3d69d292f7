"""Slot-based continuous batching over the decode loop, from
:mod:`repro.serve.scheduler` (``ContinuousBatcher``).

The scheduler owns ``cfg.batch`` decode slots.  Requests queue FIFO.
Between decode segments (``cfg.sync_every`` steps, the only host syncs),
free slots are refilled from the queue head: the joining prompts are
padded to one power-of-two width and prefilled in one call.  A slot
retires when it emits EOS (kept) or exhausts its budget.

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

Not yet ported (later slices): the prefix cache, chunked prefill,
speculation, skip-ahead and optimistic admission with preemption,
deadlines and overload control, telemetry and attribution.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .engine import (PAD_TOKEN, ServeConfig, make_decode_loop, make_join,
                     make_paged_join)
from .kvpool import KVPool
from ..models.model_zoo import Model


def _pow2_bucket(n: int, lo: int = 16, hi: int | None = None) -> int:
    b = max(lo, 1 << max(0, n - 1).bit_length())
    return min(b, hi) if hi is not None else b


class ContinuousBatcher:
    """Greedy (or sampled) continuous batcher over a fixed slot table.

    The device is the one the parameters live on; the pools, the slot
    state and the sampling generator are made there."""

    def __init__(self, model: Model, params, cfg: ServeConfig,
                 eos_id: int | None = None, seed: int = 0):
        self.model, self.params, self.cfg = model, params, cfg
        self.eos = eos_id
        self.device = dev = params["embed"]["table"].device
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
        self._loops: dict[tuple[int, int | None], object] = {}
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
        self.joins = 0
        self.segments = 0

    def submit(self, rid: int, prompt: list[int]) -> None:
        if not prompt:
            raise ValueError("empty prompt")
        self.queue.append((rid, list(prompt)))

    def _loop(self, steps: int, kv_cap: int | None = None):
        """The decode loop of ``(steps, kv_cap)``; ``kv_cap`` is None on the
        paged path, whose bound is the page table's slice."""
        key = (steps, kv_cap)
        if key not in self._loops:
            self._loops[key] = make_decode_loop(
                self.model, self.cfg, steps=steps, eos_id=self.eos,
                kv_cap=kv_cap, paged=self.cfg.paged)
        return self._loops[key]

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

    def _admit_next(self, slot: int, max_new: int):
        """Pop the queue head for ``slot``; paged, only if the pool can hold
        its worst case, which is then reserved (FIFO: a head that does not
        fit blocks)."""
        if not self.queue:
            return None
        if self.pool is None:             # dense: a free slot is enough
            rid, p = self.queue.popleft()
            self.admit_order.append(rid)
            return rid, p
        rid, p = self.queue[0]
        if not self.pool.can_admit(len(p) + max_new):
            return None
        self.queue.popleft()
        self.pool.reserve(slot, len(p) + max_new)
        self.admit_order.append(rid)
        return rid, p

    def _retire(self, slot: int, rid: int, out: list[int]) -> None:
        self.results[rid] = out
        self.slot_rid[slot] = None
        if self.pool is not None:
            self.pool.release(slot)

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
        b, dev = self.cfg.batch, self.device
        width = _pow2_bucket(max(len(p) for _, _, p in take), lo=8,
                             hi=self.cfg.max_len)

        def up(a):
            return torch.as_tensor(a, device=dev)
        if self.pool is None:
            prompts = np.zeros((len(take), width), np.int32)
            for j, (_, _, p) in enumerate(take):
                prompts[j, :len(p)] = p
            (self.caches, self.tok, self.lengths, self.done, self.remaining,
             first) = self._join(
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
            (self.caches, self.tok, self.lengths, self.done, self.remaining,
             first) = self._join(
                self.params, self.caches, self.tok, self.lengths, self.done,
                self.remaining, mask_t, up(prompts), up(plens),
                up(np.full((b,), max_new, np.int32)), self.gen,
                up(self.pool.table), up(np.zeros((b,), np.int32)), mask_t)
            first = first.cpu().numpy()
        self.joins += 1
        for slot, rid, p in take:
            tokv = int(first[slot])
            out = [tokv]
            self.outputs[rid] = out
            self.slot_len[slot] = len(p)
            if (self.eos is not None and tokv == self.eos) or max_new <= 1:
                self._retire(slot, rid, out)     # retired at commit
            else:
                self.slot_rid[slot] = rid
                self.slot_budget[slot] = max_new

    def _collect(self, emitted: np.ndarray) -> None:
        """Drain one segment's emitted block [steps, B] into per-request
        outputs, with the device's retirement rules."""
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
                    self._retire(i, rid, out)
                    break
            if appended == 0 and self.slot_rid[i] is not None:
                raise RuntimeError(
                    f"slot {i} (request {rid}) stalled: device reports done "
                    "but host bookkeeping thinks it is live")

    def _decode_segment(self, steps: int) -> torch.Tensor:
        """Run one decode segment of ``steps`` steps over the live slots,
        bounded by the page cap (paged) or ``_kv_cap`` (dense); returns the
        emitted tokens [steps, B] on the device."""
        if self.pool is not None:
            cap = self._page_cap()
            extra = (torch.as_tensor(
                np.ascontiguousarray(self.pool.table[:, :cap]),
                device=self.device),)
            loop = self._loop(steps)
        else:
            extra = ()
            loop = self._loop(steps, self._kv_cap(steps))
        ((self.tok, self.caches, self.lengths, self.done, self.remaining),
         emitted) = loop(self.params, self.tok, self.caches, self.lengths,
                         self.done, self.remaining, self.gen, *extra)
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
            self._collect(self._decode_segment(steps).cpu().numpy())
        return self.results


Batcher = ContinuousBatcher
