"""Slot-based continuous batching over the paged decode loop, from
:mod:`repro.serve.scheduler` (``ContinuousBatcher``, paged mode).

The scheduler owns ``cfg.batch`` decode slots sharing one pooled KV
allocation.  Requests queue FIFO.  Between decode segments
(``cfg.sync_every`` steps, the only host syncs), every free slot is
refilled from the queue head when the pool can hold the request's worst
case (prompt + budget pages, "reserve" admission): the joining prompts
are padded to one power-of-two width and prefilled in one call through
the page table, and rows outside the join write nothing to live pages.
A slot retires when it emits EOS (kept) or exhausts its budget; its pages
go back to the pool at the segment boundary.

Each segment slices the page table to a power-of-two bound on the deepest
live slot's page count (page-cap bucketing), so the attention kernels
never walk pages past every slot's allocation.

Not yet ported (later slices): the prefix cache, chunked prefill,
speculation, skip-ahead and optimistic admission with preemption,
deadlines and overload control, telemetry and attribution.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .engine import PAD_TOKEN, ServeConfig, make_decode_loop, make_paged_join
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
        self.pool = KVPool(cfg.pool_pages, cfg.page_size, b,
                           max_pages=cfg.max_pages)
        self.caches = model.init_paged_caches(
            b, cfg.pool_pages, cfg.page_size, cfg.dtype, device=dev)
        self._join = make_paged_join(model, cfg, eos_id=eos_id)
        self._loops: dict[int, object] = {}
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
        self.admit_order: list[int] = []
        self.joins = 0
        self.segments = 0

    def submit(self, rid: int, prompt: list[int]) -> None:
        if not prompt:
            raise ValueError("empty prompt")
        self.queue.append((rid, list(prompt)))

    def _loop(self, steps: int):
        if steps not in self._loops:
            self._loops[steps] = make_decode_loop(
                self.model, self.cfg, steps=steps, eos_id=self.eos)
        return self._loops[steps]

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
        """Pop the queue head and reserve its worst case on ``slot`` if the
        pool can hold it (FIFO: a head that does not fit blocks)."""
        if not self.queue:
            return None
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
        join_mask = np.zeros((b,), bool)
        prompts = np.zeros((b, width), np.int32)
        plens = np.ones((b,), np.int32)
        for slot, _, p in take:
            join_mask[slot] = True
            prompts[slot, :len(p)] = p
            plens[slot] = len(p)

        def up(a):
            return torch.as_tensor(a, device=dev)
        mask_t = up(join_mask)
        (self.caches, self.tok, self.lengths, self.done, self.remaining,
         first) = self._join(
            self.params, self.caches, self.tok, self.lengths, self.done,
            self.remaining, mask_t, up(prompts), up(plens),
            up(np.full((b,), max_new, np.int32)), self.gen,
            up(self.pool.table), up(np.zeros((b,), np.int32)), mask_t)
        self.joins += 1
        first = first.cpu().numpy()
        for slot, rid, p in take:
            tokv = int(first[slot])
            out = [tokv]
            self.outputs[rid] = out
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
                if ((self.eos is not None and v == self.eos)
                        or len(out) >= self.slot_budget[i]):
                    self._retire(i, rid, out)
                    break
            if appended == 0 and self.slot_rid[i] is not None:
                raise RuntimeError(
                    f"slot {i} (request {rid}) stalled: device reports done "
                    "but host bookkeeping thinks it is live")

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
            if (self.pool.pages_for(len(prompt) + max_new)
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
            cap = self._page_cap()
            pages = torch.as_tensor(
                np.ascontiguousarray(self.pool.table[:, :cap]),
                device=self.device)
            ((self.tok, self.caches, self.lengths, self.done,
              self.remaining), emitted) = self._loop(steps)(
                self.params, self.tok, self.caches, self.lengths, self.done,
                self.remaining, self.gen, pages)
            self.segments += 1
            self._collect(emitted.cpu().numpy())
        return self.results


Batcher = ContinuousBatcher
