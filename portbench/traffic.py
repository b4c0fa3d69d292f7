"""The one traffic generator: a traffic mix is a data file of parameters
(``portbench/traffic/<name>.json``) that this module reads.

Keys of a mix:

- ``kind``: ``"backlog"`` (a closed backlog: the client keeps at least
  ``queue_depth`` requests queued all window) or ``"open"`` (an open
  loop: Poisson arrivals at ``rate_per_s``, timed from their scheduled
  arrival);
- ``slots``, ``max_len``, ``page_size``, ``total_pages``,
  ``sync_every``: the batcher's size (``total_pages`` null: every slot's
  worst case);
- ``prompt_tokens`` and ``output_tokens``: ``{"dist": "log_uniform",
  "lo": a, "hi": b}``, token counts from a to b;
- ``ramp_s`` (open): seconds of arrivals before the window opens;
  ``ramp_completions`` (backlog): requests that finish before it opens
  (default half the slots); ``stagger`` (backlog): the first fill draws
  each request's output count as a uniform share of its draw, so
  completions are staggered from the first rounds;
- ``block``: requests in one stratified block (below);
- ``order``: ``"seed"`` (the default) or ``"fixed"`` (below).

Every seed serves the same work: the lengths of a block of ``block``
requests are the distribution's quantiles at (i + 1/2) / block, i = 0 ..
block - 1, permuted, and so are an open loop's gaps between arrivals
(quantiles of the exponential at the mean ``1 / rate_per_s``).  The
permutation is the seed's, or with ``order`` ``"fixed"`` one drawn from a
constant, the same for every seed (for a mix whose rate moves with the
order of its sizes more than a check's bound allows).  Token ids are
drawn uniformly over the vocabulary from the seed.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    out_len: int
    arrival: float = 0.0       # open loop: seconds after the clock's zero


def _quantiles(dist: dict, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    kind = dist.get("dist", "log_uniform")
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if kind == "log_uniform":
        v = lo * (hi / lo) ** q
    elif kind == "uniform":
        v = lo + (hi - lo) * q
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


@dataclasses.dataclass
class Mix:
    name: str
    kind: str
    slots: int
    max_len: int
    prompt_tokens: dict
    output_tokens: dict
    page_size: int = 16
    total_pages: int | None = None
    sync_every: int = 8
    queue_depth: int = 0
    rate_per_s: float = 0.0
    ramp_s: float = 0.0
    stagger: bool = False
    ramp_completions: int | None = None
    block: int = 256
    order: str = "seed"

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "Mix":
        path = pathlib.Path(path)
        raw = json.loads(path.read_text())
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields - {"why"}
        if unknown:
            raise ValueError(f"{path}: unknown traffic keys {sorted(unknown)}")
        raw = {k: v for k, v in raw.items() if k in fields}
        raw.setdefault("name", path.stem)
        mix = cls(**raw)
        mix.validate()
        return mix

    def validate(self) -> None:
        if self.kind not in ("backlog", "open"):
            raise ValueError(f"{self.name}: kind must be backlog or open")
        if self.order not in ("seed", "fixed"):
            raise ValueError(f"{self.name}: order must be seed or fixed")
        if self.kind == "open" and self.rate_per_s <= 0:
            raise ValueError(f"{self.name}: an open loop needs rate_per_s")
        if self.prompt_tokens["hi"] + self.output_tokens["hi"] > self.max_len:
            raise ValueError(f"{self.name}: the longest prompt and output "
                             "do not fit max_len")

    @property
    def max_new(self) -> int:
        """The batcher's one budget: the longest output drawn."""
        return int(self.output_tokens["hi"])

    @property
    def max_pages(self) -> int:
        return -(-self.max_len // self.page_size)

    def pool_pages(self) -> int:
        return (self.total_pages if self.total_pages is not None
                else self.slots * self.max_pages)


class Stream:
    """The mix's requests for one seed, drawn block by block on demand:
    ``next()`` gives the next request (rid 0, 1, ...)."""

    def __init__(self, mix: Mix, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.rng = np.random.default_rng(int(seed))
        # the order of sizes and gaps: the seed's, or one fixed order
        self.order_rng = (self.rng if mix.order == "seed"
                          else np.random.default_rng(0))
        self._pending: list[Request] = []
        self._rid = 0
        self._clock = 0.0
        self._first = None
        if mix.kind == "backlog" and mix.stagger:
            # the first fill owes a share of a draw, so the slots finish
            # staggered from the first rounds: the k draws' quantiles
            # times the shares (i + 1/2) / k, paired the same way for
            # every seed (one fixed permutation), so every seed's first
            # fill owes the same multiset, in its own order
            k = mix.slots
            share = (np.arange(k) + 0.5) / k
            pair = np.random.default_rng(0).permutation(k)
            owed = np.maximum(1, np.ceil(
                _quantiles(mix.output_tokens, k) * share[pair]))
            self._first = self.order_rng.permutation(owed.astype(np.int64))

    def _block(self) -> None:
        mix, rng, n = self.mix, self.rng, self.mix.block
        plen = self.order_rng.permutation(_quantiles(mix.prompt_tokens, n))
        olen = self.order_rng.permutation(_quantiles(mix.output_tokens, n))
        gaps = np.zeros(n)
        if mix.kind == "open":
            q = (np.arange(n) + 0.5) / n
            gaps = self.order_rng.permutation(-np.log1p(-q) / mix.rate_per_s)
        for p, o, g in zip(plen, olen, gaps):
            if self._first is not None and self._rid < len(self._first):
                o = self._first[self._rid]
            self._clock += float(g)
            prompt = rng.integers(0, self.vocab, size=int(p)).tolist()
            self._pending.append(Request(self._rid, prompt, int(o),
                                         self._clock))
            self._rid += 1

    def next(self) -> Request:
        if not self._pending:
            self._block()
        return self._pending.pop(0)


def warm_prompt_lengths(mix: Mix) -> list[int]:
    """One prompt length for every join width and every decode bucket the
    mix can reach, so that set-up runs each shape once.

    A join pads its prompts to a power-of-two width (at least 8, at most
    ``max_len``); a decode segment slices the page table to a power-of-two
    bound (at least 2, at most ``max_pages``) on the deepest live slot's
    pages, each slot holding its prompt and the budget ``max_new``."""
    lo, hi = int(mix.prompt_tokens["lo"]), int(mix.prompt_tokens["hi"])

    def pow2(n: int, floor: int, cap: int) -> int:
        return min(cap, max(floor, 1 << max(0, n - 1).bit_length()))

    def width(p: int) -> int:
        return pow2(p, 8, mix.max_len)

    def cap(p: int) -> int:
        pages = -(-(p + mix.max_new) // mix.page_size)
        return pow2(pages, 2, mix.max_pages)

    wanted_w = {width(p) for p in range(lo, hi + 1)}
    wanted_c = {cap(p) for p in range(lo, hi + 1)}
    chosen: list[int] = []
    while wanted_w or wanted_c:
        # the longest prompt that covers the most shapes still wanted
        p = max(range(lo, hi + 1), key=lambda p: (
            (width(p) in wanted_w) + (cap(p) in wanted_c), p))
        chosen.append(p)
        wanted_w.discard(width(p))
        wanted_c.discard(cap(p))
    return sorted(chosen)
