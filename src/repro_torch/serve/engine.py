"""Serving engine of the port: the joins (dense and paged) and the
device-resident decode loop, from :mod:`repro.serve.engine`.

The JAX decode loop is one jitted ``lax.scan`` of ``sync_every`` steps,
compiled once per ``(steps, kv_cap)`` or ``(steps, page cap)`` bucket
with the caches donated.  Here the loop's body is a Python loop of
``steps`` decode steps whose state (tokens, caches, per-slot lengths,
done flags, budgets) stays in device tensors, with sampling on the
device; nothing inside a segment reads a value back to the host.  The
loop reads and writes only tensors its caller holds (the slot state is
written back in place at its end, the KV stripes and pools are updated in
place where JAX donates them), so on the card it is captured once per
bucket as one CUDA graph (:class:`GraphedLoop`) and replayed once a
segment: one host launch a segment instead of one a kernel.  The emitted
tokens are read once, by the scheduler, per segment.  On the CPU, or when
asked, the loop runs eagerly.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..kernels import launches
from ..models.model_zoo import Model

PAD_TOKEN = -1    # emitted-slot sentinel: "slot was already retired"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The served subset of ``repro.serve.engine.ServeConfig``.  Features
    the port does not serve yet (prefix cache, chunked prefill,
    speculation, optimistic admission, overload control, tracing) have no
    fields here.  ``paged`` picks the KV layout: dense per-slot stripes
    of ``max_len`` rows (the default, as in JAX), or fixed-size pages in
    one pooled allocation with per-slot page tables."""
    max_len: int
    batch: int
    dtype: torch.dtype = torch.bfloat16
    temperature: float = 0.0     # 0 = greedy
    sync_every: int = 8          # decode steps per host sync
    paged: bool = False          # paged pool instead of dense stripes
    page_size: int = 16          # KV rows per page (paged)
    total_pages: int | None = None   # pool size; None -> batch * max pages
    # admission policy: "fifo" keeps strict head-of-line order; the opt-in
    # "skip-ahead" scans up to ``admission_lookahead`` queued requests for
    # the first one whose pages fit when the head does not.  A bypassed
    # request is charged one skip each time; once it has been skipped
    # ``admission_max_skips`` times it becomes a barrier (nothing is
    # admitted past it until it fits), so a big prompt cannot starve.
    # 0 skips makes skip-ahead FIFO.  Dense stripes admit on a free slot
    # alone, so the policy only acts on the paged pool.
    admission: str = "fifo"
    admission_lookahead: int = 8
    admission_max_skips: int = 8

    def __post_init__(self):
        if self.max_len <= 0 or self.batch <= 0 or self.page_size <= 0:
            raise ValueError("max_len, batch and page_size must be positive")
        if self.admission not in ("fifo", "skip-ahead"):
            raise ValueError(f"unknown admission policy {self.admission!r}")

    @property
    def max_pages(self) -> int:
        """Page-table width: pages needed for a full-length slot."""
        return -(-self.max_len // self.page_size)

    @property
    def pool_pages(self) -> int:
        return (self.total_pages if self.total_pages is not None
                else self.batch * self.max_pages)


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32, on the logits' device.

    Greedy (``temperature <= 0``) is the argmax, first index on ties as in
    JAX.  Otherwise a categorical draw at ``temperature`` by the Gumbel-max
    trick with noise from ``generator``: a sample of the same distribution
    as ``jax.random.categorical``, not the same numbers."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits / temperature + gumbel,
                        dim=-1).to(torch.int32)


def make_decode_loop(model: Model, cfg: ServeConfig, *, steps: int,
                     eos_id: int | None, kv_cap: int | None = None,
                     paged: bool = False):
    """Build the multi-token decode driver.

    Returns ``loop(params, tok, caches, lengths, done, remaining, gen,
    pages=None) -> emitted``, ``emitted`` [steps, B] int32 with PAD_TOKEN
    in retired slots.  The slot state (``tok`` [B, 1], and ``lengths``,
    ``done`` and ``remaining`` [B]) is read by the first step, and the
    last writes the final state back into the same tensors (``copy_``);
    the caches are written in place.  So the loop touches only tensors
    its caller holds, and a CUDA graph of it replays segment after
    segment (:class:`GraphedLoop`).  Per-slot ``lengths`` drive the cache
    writes, RoPE positions and attention masks; ``done`` freezes retired
    slots (EOS, budget or ``max_len``).

    Dense (``paged`` False): ``kv_cap`` bounds the stripe rows each step's
    attention reads, a host-known bound on the deepest live slot over the
    segment (the scheduler's ``_kv_cap``); None reads every row.  Paged:
    the loop takes ``pages``, the [B, P_cap] slice of the page table,
    constant across the segment (admission reserved every slot's worst
    case), and the slice plays ``kv_cap``'s role."""
    temp = cfg.temperature

    def loop(params, tok, caches, lengths, done, remaining, gen, pages=None):
        if paged != (pages is not None):
            raise ValueError("the paged loop takes pages; the dense loop "
                             "takes none")
        state = (tok, lengths, done, remaining)
        emitted = []
        for _ in range(steps):
            logits, caches = model.decode_step(
                params, tok, caches, lengths, dtype=cfg.dtype, pages=pages,
                kv_cap=None if paged else kv_cap)
            nxt = sample_tokens(logits[:, -1], temp, gen)
            emitted.append(torch.where(done, PAD_TOKEN, nxt))
            if eos_id is None:
                is_eos = torch.zeros_like(done)
            else:
                is_eos = nxt == eos_id
            live = (~done).to(torch.int32)
            remaining = remaining - live
            lengths = lengths + live
            new_done = (done | is_eos | (remaining <= 0)
                        | (lengths >= cfg.max_len))
            tok = torch.where(done[:, None], tok, nxt[:, None])
            done = new_done
        for held, final in zip(state, (tok, lengths, done, remaining)):
            held.copy_(final)
        return torch.stack(emitted)
    return loop


def _addresses(tree) -> tuple[int, ...]:
    """Data pointers of every tensor in a nest of lists, tuples and
    dicts, in order (None and generators are skipped)."""
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(),)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return tuple(p for t in tree for p in _addresses(t))
    return ()


class GraphedLoop:
    """One bucket's decode loop (:func:`make_decode_loop`) as one captured
    CUDA graph, replayed once a segment.

    The first call runs ``loop`` eagerly on ``stream``, a side stream:
    that is the segment's own work and the capture's warm-up (it builds
    the extensions, sets the kernels' function attributes and the
    stream's cuBLAS workspace).  Then ``loop`` is captured on the same
    stream into one ``torch.cuda.CUDAGraph``, in the memory pool ``pool``
    that all of a batcher's graphs share, and every later call replays
    it.  A graph reads the addresses it was captured with, so every call
    must pass the same state, cache and page tensors: a call with one
    rebound raises.  With ``sampled`` (a temperature above 0) the
    sampling generator is registered with the graph, so each replay
    draws fresh noise and a seed reproduces a run.  A capture that fails
    raises; nothing falls back to the eager loop.

    The kernel wrappers record the launches a capture holds
    (:mod:`repro_torch.kernels.launches`), and each replay counts them
    again, so the launch counts say what the card ran.  ``emitted`` is the
    graph's static output: read it before the next replay of any graph
    of the pool.  ``capture_s`` is the capture's and instantiation's
    seconds, ``launches`` one replay's kernel launches."""

    def __init__(self, loop, *, stream: torch.cuda.Stream, pool,
                 sampled: bool):
        self.loop, self.stream, self.pool = loop, stream, pool
        self.sampled = sampled
        self.graph: torch.cuda.CUDAGraph | None = None
        self.emitted: torch.Tensor | None = None
        self.launches: dict[str, int] = {}
        self.capture_s = 0.0
        self._captured_at: tuple[int, ...] = ()

    def __call__(self, params, tok, caches, lengths, done, remaining, gen,
                 pages=None) -> torch.Tensor:
        args = (params, tok, caches, lengths, done, remaining, gen, pages)
        at = _addresses(args[1:])
        if self.graph is not None:
            if at != self._captured_at:
                raise RuntimeError(
                    "a decode graph was called with tensors other than "
                    "the ones it was captured with: the slot state, the "
                    "caches and the page table must be written in place")
            self.graph.replay()
            launches.replayed(self.launches)
            return self.emitted
        here = torch.cuda.current_stream()
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            emitted = self.loop(*args)            # warm-up: this segment
        here.wait_stream(self.stream)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.sampled:
            graph.register_generator_state(gen)
        with launches.recording() as tally, torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream):
            self.emitted = self.loop(*args)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.launches, self._captured_at = graph, tally, at
        return emitted


def make_join(model: Model, cfg: ServeConfig, *, eos_id: int | None):
    """Dense slot refill, as the JAX join: batch-prefill every row into
    fresh W-row stripes, the joining prompts (padded to one width W) in
    their slots and zero prompts in the others, as the JAX scheduler builds
    them; then copy the joining rows into the serving stripes, in place.
    Only the joining rows are written: every other slot's stripe rows,
    token, length and flags stay bit-for-bit the same.  Every row is
    computed because with MoE blocks rows interact (each token of a call
    takes expert capacity); for a dense-MLP model the joining rows alone
    would give the same values, at no measured saving (``chip_smoke.py``'s
    ``dense_join_rows``).

    ``join(params, caches, tok, lengths, done, remaining, rows, prompts,
    plens, budgets, gen)``: ``rows`` [J] int64 names the joining slots, and
    ``prompts`` [J, W], ``plens`` [J] and ``budgets`` [J] are theirs, in
    that order.  The slot state (``tok``, ``lengths``, ``done``,
    ``remaining``) is written in place (``index_copy_``), so a decode
    graph captured over those tensors reads the joined rows.  Returns
    (caches, tok, lengths, done, remaining, first), the same tensors it
    was given and ``first`` [J], the joining rows' first sampled
    tokens."""
    temp = cfg.temperature

    def join(params, caches, tok, lengths, done, remaining, rows, prompts,
             plens, budgets, gen):
        b, width = tok.shape[0], prompts.shape[1]
        logits, fresh = model.prefill(
            params, {"tokens": prompts.new_zeros((b, width)).index_copy(
                0, rows, prompts)}, width, dtype=cfg.dtype,
            last_pos=plens.new_zeros(b).index_copy(0, rows, plens - 1))
        logits = logits[rows]
        for new, old in zip(fresh, caches):
            for name in ("k", "v"):
                old[name][:, :, :width].index_copy_(
                    1, rows, new[name][:, :, :width].index_select(1, rows))
        first = sample_tokens(logits[:, -1], temp, gen)
        if eos_id is None:
            is_eos = torch.zeros_like(first, dtype=torch.bool)
        else:
            is_eos = first == eos_id
        rem_new = budgets - 1
        tok.index_copy_(0, rows, first[:, None])
        lengths.index_copy_(0, rows, plens)
        remaining.index_copy_(0, rows, rem_new)
        done.index_copy_(0, rows, is_eos | (rem_new <= 0))
        return caches, tok, lengths, done, remaining, first
    return join


def make_paged_join(model: Model, cfg: ServeConfig, *, eos_id: int | None):
    """Paged slot refill.  The batch prefill writes through the page
    table, and rows outside ``join_mask`` get an all-sentinel table, so
    their writes never reach a live page: occupied slots' pages stay
    bit-for-bit intact in the shared pool.  ``prefix_lens`` [B] is each
    joining row's resident depth (0 for a whole-prompt prefill) and
    ``commit_mask`` [B] the joining rows whose prompt completes with this
    call (``commit_mask == join_mask`` when prompts are not chunked).  The
    slot state is written in place, as in :func:`make_join`.  Returns
    (caches, tok, lengths, done, remaining, first), the state tensors the
    same ones it was given."""
    temp = cfg.temperature
    sentinel = cfg.pool_pages      # the pool's out-of-range id

    def join(params, caches, tok, lengths, done, remaining, join_mask,
             prompts, plens, budgets, gen, pages, prefix_lens, commit_mask):
        write_tbl = torch.where(join_mask[:, None], pages,
                                torch.full_like(pages, sentinel))
        logits, caches = model.prefill_paged(
            params, {"tokens": prompts}, caches, write_tbl, dtype=cfg.dtype,
            last_pos=plens - 1, cache_len=prefix_lens)
        first = sample_tokens(logits[:, -1], temp, gen)
        if eos_id is None:
            is_eos = torch.zeros_like(join_mask)
        else:
            is_eos = first == eos_id
        rem_new = budgets - 1
        new = (torch.where(commit_mask[:, None], first[:, None], tok),
               torch.where(join_mask, prefix_lens + plens, lengths),
               torch.where(commit_mask, is_eos | (rem_new <= 0),
                           join_mask | done),
               torch.where(commit_mask, rem_new,
                           torch.where(join_mask, 0, remaining)))
        for held, value in zip((tok, lengths, done, remaining), new):
            held.copy_(value)
        return caches, tok, lengths, done, remaining, first
    return join
