"""Block-pool KV-cache memory manager (host side of the paged subsystem).

The port's copy of :mod:`repro.serve.kvpool`, kept whole: it is numpy
only, and importing it from ``repro.serve`` would pull in JAX.  The
prefix-cache, preemption and chaos partitions below are unused by the
port's scheduler so far; they stay so that later slices port those
features onto the same allocator.

The dense slot table (PR 1) gives every slot a ``[max_len]`` KV stripe, so
memory is capped by ``slots x max_len`` whether or not those tokens exist —
retired and short requests strand capacity.  The paper's co-design lesson
(§4.2 blocked placement, §5.1.2 command skipping) is to never spend
commands or capacity on dead data, and PrIM-style studies put placement
management, not compute, at the center of near-memory wins.  The paged
analogue: KV lives in fixed-size **pages** inside one pooled allocation
(``[layers, n_pages, page_size, kv_heads, head_dim]`` per segment, see
:func:`repro_torch.models.transformer.init_paged_caches`); each slot holds an
ordered list of page ids (its **page table**), pages come from a free list,
and retirement returns every page exactly once.

This class is pure host bookkeeping — no torch.  The device sees only the
``table`` array ([slots, max_pages] int32, unallocated entries =
``sentinel`` = ``n_pages``, i.e. one past the pool's live pages: the
pooled caches' page of that id is never written, so reads through an
unallocated entry see zeros, and writes through one land in the sink page
after it, which is never read);
the scheduler uploads (a column-slice of) it around each decode segment.

Prefix-cache lifecycle (PR 3, :mod:`repro.serve.prefixcache`): a page is
born on the free list, mapped into one slot by :meth:`reserve` /
:meth:`extend` (refcount 1), and — if it holds a full, immutable page of
prompt tokens — registered in the radix cache.  Later requests with the
same prompt prefix map the *same* page via :meth:`share`, taking its
refcount above 1; only full page-aligned prefix chunks are ever shared, so
a shared page is never written again (the first partially-filled page of
every prompt stays private — no copy-on-write).  When the last slot
mapping a registered page retires, :meth:`release` parks it in the
**evictable cached** state (refcount 0, not free, ``cacheable`` argument)
instead of freeing it: the KV stays resident for future matches at zero
reserved cost.  A new match revives it straight back to refcount 1
(:meth:`share`), and pool pressure reclaims it (:meth:`reclaim`, driven
LRU/leaf-first by the registered ``evictor``) — so

    free -> mapped (1) -> shared (>1) -> cached (0, evictable) -> free
                                     \\-> revived (1) -> ...

and ``free + mapped + cached`` always partitions the pool exactly.

Preemption lifecycle (PR 6, :mod:`repro.serve.scheduler` optimistic
admission): when the scheduler evicts a victim slot under pool pressure,
:meth:`release` with ``preempt=True`` parks the victim's dead private
pages (refcount 0, no radix entry) in the **preempted** partition instead
of the free list.  Their KV is garbage the moment the slot's history is
the only way back (resume recomputes through the chunked-prefill path),
so :meth:`_alloc` reclaims them *before* evicting cached prefix pages —
preempted pages have zero future value, cached ones may still match.  The
partition exists for accounting: ``check()`` proves preemption conserves
pages and refcounts instead of leaking them into the free list untracked.
A fifth **held** partition backs the chaos harness
(:mod:`repro.serve.chaos`): :meth:`hold` takes free pages out of
circulation to force pool pressure at a configured round, and
:meth:`release_held` returns them — so

    free + mapped + cached + preempted + held == n_pages

always, and every non-mapped page carries refcount 0.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np


class PageError(RuntimeError):
    """Allocator invariant violation (double free, over-allocation)."""


class KVPool:
    """Free-list page allocator + per-slot page tables.

    ``n_pages`` fixed-size pages of ``page_size`` tokens are shared by
    ``slots`` decode slots, each of which may map at most ``max_pages``
    pages.  All methods are O(pages touched); nothing allocates device
    memory — the pooled KV arrays themselves live in the model caches.
    """

    def __init__(self, n_pages: int, page_size: int, slots: int,
                 max_pages: int | None = None):
        if n_pages <= 0 or page_size <= 0 or slots <= 0:
            raise ValueError("n_pages, page_size and slots must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        self.slots = slots
        self.max_pages = max_pages if max_pages is not None else n_pages
        self.sentinel = n_pages            # OOB page id: scatters drop
        # LIFO free list: recently freed pages are re-used first (their
        # HBM is warm and the table stays dense at the low ids).
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        # evictable cached pages: refcount 0 but their KV is still live
        # prefix-cache content — reclaimed on pressure via ``evictor``
        self._cached: set[int] = set()
        # preempted pages: refcount 0, KV dead (the victim resumes by
        # recompute) — first in line for reclamation on pressure
        self._preempted: set[int] = set()
        # held pages: taken out of circulation by the chaos harness to
        # force pool pressure; never allocatable until release_held()
        self._held: set[int] = set()
        self.evictor = None                # set by prefixcache.PrefixCache
        # telemetry gauge hook (set by the scheduler when tracing): called
        # with the partition sizes after every mutating operation.  None
        # (default) costs one attribute test per mutation.
        self.gauge_cb = None
        self.refcount = np.zeros((n_pages,), np.int32)
        self.table = np.full((slots, self.max_pages), self.sentinel,
                             np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(slots)]

    # ------------------------------------------------------------------
    # capacity queries (the scheduler's admission rule)
    # ------------------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` KV rows."""
        return -(-max(0, tokens) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Pages in the evictable cached state (refcount 0, KV resident)."""
        return len(self._cached)

    @property
    def preempted_pages(self) -> int:
        """Pages parked by slot preemption (refcount 0, KV dead) —
        reclaimed before anything else on pressure."""
        return len(self._preempted)

    @property
    def held_pages(self) -> int:
        """Pages taken out of circulation by the chaos harness."""
        return len(self._held)

    @property
    def used_pages(self) -> int:
        """Pages mapped by live slots (cached/preempted/held pages are
        *not* used — they hold no live slot's KV)."""
        return (self.n_pages - len(self._free) - len(self._cached)
                - len(self._preempted) - len(self._held))

    def cached_page_ids(self) -> list[int]:
        return sorted(self._cached)

    def pressure(self) -> float:
        """Fraction of the pool no admission could be granted from:
        mapped (live slots' KV) plus chaos-held pages over the total.
        Free, cached and preempted pages all count as *available* — the
        evictor reclaims the latter two on demand — so 1.0 means every
        grantable page is pinned under live work.  This is the pool
        signal the overload DegradationController climbs its ladder on
        (burn rate is the other)."""
        return (self.used_pages + self.held_pages) / self.n_pages

    def is_cached(self, page: int) -> bool:
        return page in self._cached

    def can_admit(self, tokens: int,
                  shared_pages: Iterable[int] = ()) -> bool:
        """Would admitting a ``tokens``-token request succeed, given that
        ``shared_pages`` of its prefix are already resident (mapped or
        cached) and need no fresh allocation?  Cached pages count as
        available — the evictor reclaims them on demand."""
        shared = set(shared_pages)
        total = self.pages_for(tokens)
        if total > self.max_pages:
            return False
        avail = (len(self._free) + len(self._preempted)
                 + len(self._cached - shared))
        return total - len(shared) <= avail

    def slot_pages(self, slot: int) -> list[int]:
        return list(self._slot_pages[slot])

    def _notify(self) -> None:
        """Telemetry gauge: report the partition sizes after a mutation
        (free + mapped + cached + preempted + held == n_pages always —
        the counter track in the trace shows the partition flow)."""
        cb = self.gauge_cb
        if cb is not None:
            cb(free=len(self._free), mapped=self.used_pages,
               cached=len(self._cached), preempted=len(self._preempted),
               held=len(self._held))

    # ------------------------------------------------------------------
    # allocate / share / release
    # ------------------------------------------------------------------
    def _slot_snapshot(self, slot: int) -> str:
        """Debuggability suffix for allocator errors: the slot's page
        table plus the pool's partition totals at the failure point."""
        return (f" [slot {slot} pages={self._slot_pages[slot]}; pool: "
                f"{len(self._free)} free, {self.used_pages} mapped, "
                f"{len(self._cached)} cached, "
                f"{len(self._preempted)} preempted, "
                f"{len(self._held)} held / {self.n_pages}]")

    def _alloc(self, n: int) -> list[int]:
        """Pop ``n`` pages off the free list.  When the list runs short,
        reclaim preempted pages first (their KV is dead — zero future
        value), then evict cached prefix pages (theirs may still match)."""
        while n > len(self._free) and self._preempted:
            self._free.append(min(self._preempted))
            self._preempted.discard(self._free[-1])
        if n > len(self._free) and self.evictor is not None:
            self.evictor.evict(n - len(self._free))
        if n > len(self._free):
            raise PageError(
                f"pool exhausted: need {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def reserve(self, slot: int, tokens: int) -> list[int]:
        """Map pages for a ``tokens``-token request onto ``slot``.

        The whole worst case (prompt + budget) is reserved up front, so a
        request can never run out of pages mid-segment; the win over dense
        is that the reservation is ``ceil(tokens / page_size)`` pages, not
        ``max_len``, and it is returned the moment the slot retires.
        """
        if self._slot_pages[slot]:
            raise PageError(f"slot {slot} already holds pages"
                            + self._slot_snapshot(slot))
        if tokens <= 0:
            # a zero-page reservation would leave the slot indistinguishable
            # from unreserved (a second reserve would "succeed") — reject it
            raise PageError(
                f"slot {slot}: zero-token reservation (tokens={tokens})")
        n = self.pages_for(tokens)
        if n > self.max_pages:
            raise PageError(
                f"request needs {n} pages > max_pages {self.max_pages}"
                + self._slot_snapshot(slot))
        pages = self._alloc(n)
        for i, p in enumerate(pages):
            self.refcount[p] += 1
            self.table[slot, i] = p
        self._slot_pages[slot] = pages
        self._notify()
        return pages

    def share(self, slot: int, pages: list[int]) -> None:
        """Map already-resident ``pages`` (a matched prefix chain, in
        order) into empty ``slot``.  Mapped pages gain a reference
        (refcount goes above 1 — several tables now name the same page);
        cached pages are revived back to refcount 1.  Free pages cannot be
        shared — their KV is gone."""
        if self._slot_pages[slot]:
            raise PageError(f"slot {slot} already holds pages"
                            + self._slot_snapshot(slot))
        if not pages:
            raise PageError(f"slot {slot}: share of zero pages")
        if len(pages) > self.max_pages:
            raise PageError(
                f"shared prefix {len(pages)} pages > max_pages "
                f"{self.max_pages}")
        if len(set(pages)) != len(pages):
            raise PageError("shared prefix repeats a page")
        for p in pages:
            if self.refcount[p] == 0 and p not in self._cached:
                raise PageError(f"page {p} is not mapped or cached, "
                                "cannot share" + self._slot_snapshot(slot))
        for i, p in enumerate(pages):
            self._cached.discard(p)
            self.refcount[p] += 1
            self.table[slot, i] = p
        self._slot_pages[slot] = list(pages)
        self._notify()

    def extend(self, slot: int, n: int) -> list[int]:
        """Append ``n`` fresh pages after ``slot``'s current mapping — the
        private suffix + budget pages of a request whose prefix came from
        :meth:`share`."""
        if n <= 0:
            raise PageError(f"slot {slot}: zero-page extend (n={n})")
        held = self._slot_pages[slot]
        if len(held) + n > self.max_pages:
            raise PageError(
                f"slot {slot}: {len(held)} + {n} pages > max_pages "
                f"{self.max_pages}" + self._slot_snapshot(slot))
        pages = self._alloc(n)
        for i, p in enumerate(pages):
            self.refcount[p] += 1
            self.table[slot, len(held) + i] = p
        held.extend(pages)
        self._notify()
        return pages

    def release(self, slot: int,
                cacheable: frozenset[int] | set[int] = frozenset(),
                preempt: bool = False) -> int:
        """Drop ``slot``'s reference on every page it maps; returns the
        count leaving the mapped state under this slot's last reference.

        A page re-enters circulation only at refcount zero (prefix sharing
        keeps shared pages alive under their other tables).  Zero-refcount
        pages in ``cacheable`` (i.e. with a live radix entry) park in the
        evictable cached state instead of the free list — resident for
        future matches, reclaimed on pressure.  With ``preempt`` the
        remaining zero-refcount pages park in the **preempted** partition
        instead of the free list: same allocatability (``_alloc`` reclaims
        them first), but the accounting distinguishes preemption's page
        flow so ``check()`` can prove nothing leaked.  Releasing an empty
        slot is a no-op, but a page leaving the table twice is a hard
        error.
        """
        pages = self._slot_pages[slot]
        if not pages:
            return 0
        freed = 0
        for p in pages:
            if self.refcount[p] <= 0:
                raise PageError(f"double free of page {p} (slot {slot})"
                                + self._slot_snapshot(slot))
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                if p in cacheable:
                    self._cached.add(p)
                elif preempt:
                    self._preempted.add(p)
                    freed += 1
                else:
                    self._free.append(p)
                    freed += 1
        self._slot_pages[slot] = []
        self.table[slot, :] = self.sentinel
        self._notify()
        return freed

    def reclaim(self, page: int) -> None:
        """Move an evictable cached page back to the free list (called by
        the prefix cache's evictor once the radix entry is dropped)."""
        if page not in self._cached:
            raise PageError(f"reclaim of non-cached page {page}")
        self._cached.discard(page)
        self._free.append(page)
        self._notify()

    # ------------------------------------------------------------------
    # chaos / fault-injection hooks (repro.serve.chaos)
    # ------------------------------------------------------------------
    def hold(self, n: int) -> list[int]:
        """Take up to ``n`` *free* pages out of circulation (chaos-forced
        pool pressure).  Only the free list is raided — live slots, the
        prefix cache and the preempted partition are untouched, so the
        pressure arrives exactly as a smaller effective pool would."""
        taken = [self._free.pop() for _ in range(min(n, len(self._free)))]
        self._held.update(taken)
        self._notify()
        return taken

    def release_held(self) -> int:
        """Return every held page to the free list; returns the count."""
        n = len(self._held)
        self._free.extend(sorted(self._held))
        self._held.clear()
        self._notify()
        return n

    # ------------------------------------------------------------------
    # invariants / metrics
    # ------------------------------------------------------------------
    def check(self) -> None:
        """Assert global allocator consistency (used by the tests):
        free, mapped, cached, preempted and held pages partition the pool
        exactly, shared pages' refcounts equal the number of tables naming
        them, refcounts are conserved (their total equals the total table
        mappings, and every non-mapped page carries zero), and no page
        sits in two partitions at once."""
        counts: dict[int, int] = {}
        for pages in self._slot_pages:
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            if self.refcount[p] != c:
                raise PageError(
                    f"page {p} mapped {c}x but refcount {self.refcount[p]}")
        free = set(self._free)
        if len(free) != len(self._free):
            raise PageError("free list contains duplicates")
        parts = {"free": free, "cached": self._cached,
                 "preempted": self._preempted, "held": self._held}
        names = list(parts)
        for i, a in enumerate(names):
            if parts[a] & counts.keys():
                raise PageError(f"a page is both {a} and mapped")
            for b in names[i + 1:]:
                if parts[a] & parts[b]:
                    raise PageError(f"a page is both {a} and {b}")
            for p in parts[a]:
                if self.refcount[p] != 0:
                    raise PageError(f"{a} page {p} has refcount "
                                    f"{self.refcount[p]}")
        if (len(free) + len(counts) + len(self._cached)
                + len(self._preempted) + len(self._held) != self.n_pages):
            raise PageError(
                "free + mapped + cached + preempted + held pages != pool")
        # refcount conservation: the refcount total is exactly the total
        # number of table mappings (negatives cancelling positives, or a
        # stray count on an unmapped page, would slip the per-page checks
        # above only via a bookkeeping structure they don't look at)
        if (self.refcount < 0).any():
            raise PageError("negative refcount")
        total_refs = int(self.refcount.sum())
        total_maps = sum(len(ps) for ps in self._slot_pages)
        if total_refs != total_maps:
            raise PageError(f"refcount total {total_refs} != "
                            f"{total_maps} table mappings")
        for slot, pages in enumerate(self._slot_pages):
            if list(self.table[slot, :len(pages)]) != pages:
                raise PageError(f"table row {slot} out of sync"
                                + self._slot_snapshot(slot))
            if not (self.table[slot, len(pages):] == self.sentinel).all():
                raise PageError(f"table row {slot} has stale tail entries"
                                + self._slot_snapshot(slot))

    def snapshot(self) -> dict:
        """JSON-serializable allocator state — the pool section of the
        scheduler's flight-recorder bundle (and a debugging aid on its
        own: every partition, every slot's table, every refcount)."""
        return {"n_pages": self.n_pages,
                "page_size": self.page_size,
                "max_pages": self.max_pages,
                "free": sorted(self._free),
                "cached": sorted(self._cached),
                "preempted": sorted(self._preempted),
                "held": sorted(self._held),
                "slot_pages": [list(p) for p in self._slot_pages],
                "refcount": [int(c) for c in self.refcount]}

    def utilization(self, live_tokens: int) -> float:
        """live tokens / token capacity mapped by live slots (1.0 = no
        page waste; prefix sharing can push this *above* 1.0 — several
        slots' live tokens counting one physical page)."""
        cap = self.used_pages * self.page_size
        return live_tokens / cap if cap else 0.0
