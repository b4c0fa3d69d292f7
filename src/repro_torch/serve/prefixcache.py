"""Shared-prefix radix cache over the paged KV pool, the port's copy of
:mod:`repro.serve.prefixcache` (framework-free host bookkeeping, over the
port's :class:`~repro_torch.serve.kvpool.KVPool`).

Prompt recomputation is the redundancy this removes: every request that
carries the same system or few-shot prefix would re-prefill and re-store
KV that already sits, bit for bit, in the page pool.

Structure: a radix tree keyed on **page-aligned token chunks**.  Each edge
is a full page (``page_size`` tokens) of prompt, and each node names the
pooled page that holds that chunk's KV.  So sharing has the pool's
allocation granularity:

* only **full, immutable prefix pages** are shared.  A prompt's first
  partly filled page stays private to its slot, so a shared page is never
  written again and no copy-on-write is needed;
* a match is capped so that at least one prompt token is left as suffix:
  the prefill needs a real token to produce next-token logits.

Lifecycle of a page (see also :mod:`repro_torch.serve.kvpool`):

    free -> mapped (refcount 1) -> registered here at admission
         -> shared (refcount > 1) as later requests match it
         -> evictable cached (refcount 0, radix entry live) at retirement
         -> revived by a new match, or reclaimed (LRU, leaf-first) on
            pool pressure -> free

Eviction is leaf-first in LRU order: a node is dropped only once it has
no children, so a cached chain is peeled from its deep end and a match
never dangles mid-chain.  A slot maps its matched chain contiguously from
the root, so a mapped node (refcount > 0) never sits below a cached one,
and the leaf-first walk reaches every cached page.

Only the pool's ``n_pages`` live pages enter the tree.  The two pages the
pooled caches hold past them (the sentinel's, read through unallocated
table entries, and the sink that takes masked-out writes) are no pool
pages: the allocator never hands them out, and :meth:`PrefixCache.insert`
refuses them.

All of this is host bookkeeping, O(pages touched) a call: the device only
ever sees the pool's page table.
"""
from __future__ import annotations

import heapq

from .kvpool import KVPool, PageError


class _Node:
    """One full-page chunk of some cached prompt prefix."""
    __slots__ = ("chunk", "page", "children", "parent", "last_use")

    def __init__(self, chunk: tuple[int, ...] | None, page: int | None,
                 parent: "_Node | None", last_use: int):
        self.chunk = chunk
        self.page = page
        self.children: dict[tuple[int, ...], _Node] = {}
        self.parent = parent
        self.last_use = last_use


class PrefixCache:
    """Radix tree of page-aligned prompt chunks -> pooled page ids.

    Registers itself as ``pool.evictor``: when the pool's free list runs
    short, :meth:`evict` reclaims cached pages (LRU, leaf-first) so the
    cache costs zero reserved capacity — it only keeps pages that nothing
    else wants yet.
    """

    def __init__(self, pool: KVPool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _Node(None, None, None, 0)
        self._by_page: dict[int, _Node] = {}
        self._clock = 0
        self.evicted_pages = 0
        pool.evictor = self

    # ------------------------------------------------------------------
    # lookup / registration
    # ------------------------------------------------------------------
    def match(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest cached page-aligned prefix of ``tokens``.

        Returns ``(pages, matched_tokens)``; the match is capped at
        ``(len(tokens) - 1) // page_size`` pages so at least one token is
        always left to prefill.  Touches the matched chain for LRU.
        """
        ps = self.page_size
        cap = max(0, (len(tokens) - 1) // ps)
        node, pages = self.root, []
        for i in range(cap):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            node = child
            pages.append(child.page)
        if pages:
            self._clock += 1
            t = node
            while t is not self.root:
                t.last_use = self._clock
                t = t.parent
        return pages, len(pages) * ps

    def insert(self, tokens: list[int], pages: list[int]) -> int:
        """Register a prompt's full pages: ``pages[i]`` holds the KV of
        ``tokens[i*ps:(i+1)*ps]``.  Chunks already present keep their
        existing page (the caller's duplicate stays private and is freed
        normally at retirement); returns the number of new entries."""
        ps = self.page_size
        if len(tokens) < len(pages) * ps:
            raise PageError("insert: pages extend past the token prefix")
        for page in pages:
            if not 0 <= page < self.pool.n_pages:
                raise PageError(f"insert: page {page} is not one of the "
                                f"pool's {self.pool.n_pages} pages")
        self._clock += 1
        node, new = self.root, 0
        for i, page in enumerate(pages):
            chunk = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                if page in self._by_page:
                    raise PageError(f"page {page} already registered")
                child = _Node(chunk, page, node, self._clock)
                node.children[chunk] = child
                self._by_page[page] = child
                new += 1
            child.last_use = self._clock
            node = child
        return new

    def registered_pages(self, pages: list[int]) -> frozenset[int]:
        """Subset of ``pages`` with a live radix entry — the ones a
        release should park in the evictable cached state."""
        return frozenset(p for p in pages if p in self._by_page)

    @property
    def n_entries(self) -> int:
        return len(self._by_page)

    # ------------------------------------------------------------------
    # eviction (pool pressure)
    # ------------------------------------------------------------------
    def evict(self, n: int) -> int:
        """Reclaim up to ``n`` cached pages to the pool's free list, LRU
        first and leaves only (a freed node may expose its parent as the
        next leaf).  Returns the number actually reclaimed.

        One pass collects the evictable leaves into a min-heap on
        ``last_use``; the cascade pushes a freed node's parent when it
        becomes an evictable leaf — O((c + n) log c) per call instead of
        a full rescan per page.  Nothing touches the LRU clock mid-call,
        so the heap order stays exact."""
        heap = []
        for page in self.pool.cached_page_ids():
            node = self._by_page.get(page)
            if node is not None and not node.children:
                heapq.heappush(heap, (node.last_use, page))
        freed = 0
        while freed < n and heap:
            _, page = heapq.heappop(heap)
            node = self._by_page[page]
            parent = node.parent
            del parent.children[node.chunk]
            del self._by_page[page]
            self.pool.reclaim(page)
            self.evicted_pages += 1
            freed += 1
            if (parent is not self.root and not parent.children
                    and self.pool.is_cached(parent.page)):
                heapq.heappush(heap, (parent.last_use, parent.page))
        return freed

    # ------------------------------------------------------------------
    # invariants
    # ------------------------------------------------------------------
    def check(self) -> None:
        """Radix/pool consistency: the tree and the page index agree, a
        registered page is mapped or cached (never free), and a mapped
        node never sits below a cached one (the leaf-first eviction
        invariant)."""
        pool = self.pool
        seen: set[int] = set()
        stack = [(self.root, False)]
        while stack:
            node, under_cached = stack.pop()
            for chunk, child in node.children.items():
                if child.parent is not node or child.chunk != chunk:
                    raise PageError("radix parent/chunk link broken")
                if self._by_page.get(child.page) is not child:
                    raise PageError(f"page index out of sync for "
                                    f"{child.page}")
                seen.add(child.page)
                cached = pool.is_cached(child.page)
                mapped = int(pool.refcount[child.page]) > 0
                if child.page in pool._preempted or child.page in pool._held:
                    # a preemption must park registered pages as evictable
                    # cached (their KV stays matchable); the preempted /
                    # held partitions are for dead private pages only
                    raise PageError(f"registered page {child.page} is in "
                                    "the preempted/held partition")
                if not (cached or mapped):
                    raise PageError(f"registered page {child.page} is "
                                    "neither mapped nor cached")
                if under_cached and mapped:
                    raise PageError(f"mapped page {child.page} below a "
                                    "cached ancestor")
                stack.append((child, under_cached or cached))
        if seen != set(self._by_page):
            raise PageError("page index holds entries not in the tree")
        for page in pool.cached_page_ids():
            if page not in self._by_page:
                raise PageError(f"cached page {page} has no radix entry")
        pool.check()
