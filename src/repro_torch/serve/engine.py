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

Self-speculative decoding (``speculate_k``) swaps the one-token step for a
draft-k verify step: :func:`ngram_propose` drafts k tokens from each
slot's own token history, one ``Model.decode_step`` at Lq = k+1 (the paged
prefill kernel) checks them, and each slot commits the longest agreeing
prefix plus the model's bonus token.  The history is one more tensor the
loop writes in place, so the speculative loop is graphed the same way.

Every join and decode loop runs inside its batcher's attention policy
(:func:`repro_torch.kernels.decode_attn.ops.decode_attn_policy`, mode
``ServeConfig.attn_mode``), the graph captures included: the route and
the tuned launch each attention op resolves at capture are baked into
the graph, as JAX resolves them at trace time.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..configs.base import ArchConfig, BlockKind
from ..kernels import launches
from ..kernels.decode_attn.ops import (MODES, DecodeAttnPolicy,
                                       decode_attn_policy)
from ..models.model_zoo import Model
from ..parthook import part

PAD_TOKEN = -1    # emitted-slot sentinel: "slot was already retired"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """``repro.serve.engine.ServeConfig``.  ``attn_mode`` routes every
    attention op (:class:`~repro_torch.kernels.decode_attn.ops.
    DecodeAttnPolicy`): ``"auto"`` (the CUDA kernels on the card, the
    plain versions on the CPU), ``"kernel"`` or ``"plain"`` (JAX's
    ``"xla"``: gather, then plain PyTorch attention); JAX's
    ``attn_interpret`` has no counterpart.  ``paged`` picks the KV layout:
    dense per-slot stripes of ``max_len`` rows (the default, as in JAX), or
    fixed-size pages in one pooled allocation with per-slot page tables.
    The prefix cache, chunked prefill, speculation and optimistic
    admission need ``paged``; the batcher checks them as JAX's does.
    ``admission_mode="optimistic"`` admits a request on its prompt's pages
    only and grows each decoding slot's table between segments; when the
    pool cannot cover the growth, a victim slot (lowest priority, then
    most pages, then least progress) is preempted and re-queued, and its
    resume recomputes its KV from prompt + committed tokens through the
    ordinary (chunked) prefill join."""
    max_len: int
    batch: int
    dtype: torch.dtype = torch.bfloat16
    temperature: float = 0.0     # 0 = greedy
    sync_every: int = 8          # decode steps per host sync
    attn_mode: str = "auto"      # attention: "auto" | "kernel" | "plain"
    paged: bool = False          # paged pool instead of dense stripes
    page_size: int = 16          # KV rows per page (paged)
    total_pages: int | None = None   # pool size; None -> batch * max pages
    # shared-prefix radix cache (serve/prefixcache.py): full prompt pages
    # are registered in a radix tree; later requests map the matched
    # pages (KVPool.share) and prefill only their suffix
    prefix_cache: bool = False
    # admission policy: "fifo" keeps strict head-of-line order; the opt-in
    # "skip-ahead" scans up to ``admission_lookahead`` queued requests for
    # the first one whose pages fit when the head does not.  A bypassed
    # request is charged one skip each time; once it has been skipped
    # ``admission_max_skips`` times it becomes a barrier (nothing is
    # admitted past it until it fits), so a big prompt cannot starve.
    # 0 skips makes skip-ahead FIFO.  Dense stripes admit on a free slot
    # alone, so the policy only acts on the paged pool.
    admission: str = "fifo"
    # admission sizing (needs paged): "reserve" (default) maps the whole
    # worst case (prompt + max_new + speculation window) at admission, so
    # a slot can never run out of pages but the pool runs far under its
    # real capacity whenever outputs finish early.  "optimistic" maps only
    # the prompt's pages at admission and grows each slot's table on
    # demand between decode segments; when growth outruns the pool the
    # scheduler preempts a victim slot (lowest priority, then most pages,
    # then least progress), parks its dead pages in the pool's preempted
    # partition and re-queues it; resume recomputes the KV from the
    # committed history through the chunked-prefill join path, with
    # prefix-cache hits shortcutting the recompute.  Attention-only in
    # JAX (a recurrent state cannot be recomputed from a page-aligned
    # resume): the batcher refuses it for a model with an SSM segment.
    admission_mode: str = "reserve"
    admission_lookahead: int = 8
    admission_max_skips: int = 8
    # chunked prefill: a joining prompt's uncached suffix is prefilled at
    # most ``prefill_chunk`` tokens a refill round (a multiple of
    # ``page_size``), the slot PREFILLING (done-latched on the device) in
    # between, so live slots' decode segments interleave with the chunks.
    # None: the whole suffix in one join
    prefill_chunk: int | None = None
    # decode-priority budget: the prefill tokens (continuations and new
    # admissions) one refill round may take; the first piece of a round
    # always goes through, later ones are deferred (``join_stats``)
    prefill_round_tokens: int | None = None
    # self-speculative decoding (greedy): each decode step drafts
    # ``speculate_k`` tokens from the slot's history (``ngram_propose``,
    # match width ``speculate_ngram``) and verifies all k+1 in one paged
    # prefill-kernel call; a committed token is the verify's own argmax,
    # so the tokens are the plain greedy loop's up to rounding (the verify
    # runs other kernels than a decode step)
    speculate_k: int | None = None
    speculate_ngram: int = 2
    # telemetry (serve/telemetry.py): when True the batcher builds a
    # Tracer recording per-request lifecycle events, per-round scheduler
    # spans, the port's inner spans (rounds, the eager join's model
    # parts) and pool-partition gauges (exportable as Perfetto
    # trace_event JSON); on the card the join and decode-segment spans
    # and the parts carry CUDA-event device intervals.  Off by default;
    # every call site is at a host sync point, a scheduling-round
    # boundary or a part of the eager join, never inside a decode
    # segment, and it adds no host sync: device marks become seconds at
    # the syncs the batcher already makes.
    telemetry: bool = False
    # SLO monitor (the batcher's slo_stats): per-request latency targets.
    # None disables the check for that metric (attainment is vacuously
    # 1.0); with a target set, every observed TTFT/TPOT is scored against
    # it per priority class, and ``slo_target`` is the attainment
    # objective the windowed burn rate is normalized by (burn rate 1.0 =
    # violating exactly the error budget, > 1.0 = burning it faster than
    # the target allows).
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None
    slo_target: float = 0.9
    # flight recorder: an always-on bounded ring of lifecycle events
    # (host dict appends at scheduling-round boundaries: no device sync,
    # no pool gauge callback).  When a PageError escapes the run loop, or
    # the watchdog trips, the batcher dumps the last ``flight_events``
    # events, the pool snapshot, the slot table and the config as a debug
    # bundle (``Batcher.last_flight_bundle``, written to ``flight_path``
    # or $REPRO_FLIGHT_PATH when set).
    flight_recorder: bool = True
    flight_events: int = 256
    flight_path: str | None = None
    # overload protection (serve/overload.py): when True the batcher runs
    # a DegradationController, a hysteresis ladder HEALTHY -> DEGRADED ->
    # SHEDDING driven by the windowed SLO burn rate and the pool-pressure
    # gauge.  DEGRADED sheds speculation and shrinks the prefill chunk;
    # SHEDDING also freezes optimistic slot growth (admission reverts to
    # worst-case reservation) and sheds lowest-priority queued work with
    # a retryable RETRY_AFTER rejection.  Degradation changes when and
    # whether work runs, never its tokens.  Deadline/timeout cancellation
    # (submit(deadline_s=..., timeout_s=...)) is always on; the
    # controller is the opt-in load-shedding half.
    overload: bool = False
    overload_degrade_burn: float = 1.0   # burn rate that enters DEGRADED
    overload_shed_burn: float = 2.0      # burn rate that enters SHEDDING
    overload_degrade_pressure: float = 0.9   # pool mapped+held fraction
    overload_shed_pressure: float = 1.0      # ... with work still queued
    overload_up_rounds: int = 2          # consecutive hot rounds to climb
    overload_down_rounds: int = 4        # consecutive cool rounds to drop
    # SHEDDING drains the queue down to this depth (None -> cfg.batch),
    # lowest-priority / latest-submitted first, never a preempted resume
    overload_queue_keep: int | None = None
    overload_retry_after_s: float = 1.0  # RETRY_AFTER hint on shed
    # progress watchdog: rounds without any join / commit / retirement /
    # preemption / cancellation before the scheduler dumps the flight
    # bundle and force-sheds the blocking head instead of looping
    watchdog_rounds: int = 100_000

    def __post_init__(self):
        if self.max_len <= 0 or self.batch <= 0 or self.page_size <= 0:
            raise ValueError("max_len, batch and page_size must be positive")
        if self.admission not in ("fifo", "skip-ahead"):
            raise ValueError(f"unknown admission policy {self.admission!r}")
        if self.attn_mode not in MODES:
            raise ValueError(f"unknown attention mode {self.attn_mode!r} "
                             f"(expected one of {MODES})")

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


# ---------------------------------------------------------------------------
# the single-step factories of the dry-run and sharding paths
# ---------------------------------------------------------------------------

def make_decode_step(model: Model, cfg: ServeConfig):
    """``step(params, tokens, caches, cache_len, extra) -> (next tokens
    [B, 1] int32, caches)``: one greedy decode step over dense stripes,
    as JAX's ``make_decode_step``."""
    from ..distributed.act_sharding import constrain

    def step(params, tokens, caches, cache_len, extra):
        logits, caches = model.decode_step(params, tokens, caches, cache_len,
                                           dtype=cfg.dtype,
                                           extra=extra or None)
        # sharded: the vocab gathered onto each batch shard for the argmax
        last = constrain(logits[:, -1], ("batch", None))
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt[:, None], caches
    return step


def sharded_decode_step(model: Model, cfg: ServeConfig, mesh,
                        input_specs: dict):
    """JAX's ``jit_decode_step`` on a torch ``DeviceMesh``: the step of
    :func:`make_decode_step` with params placed by ``param_shardings``,
    tokens and ``extra`` by ``data_shardings``, caches by
    ``cache_shardings`` and ``cache_len`` (0-d, or per slot [B])
    replicated, run under the mesh's activation policy.  Inputs that are
    not DTensors yet are placed first (each rank keeps its own shard); a
    DTensor is taken as it is.  The caches are updated in place (JAX
    donates them) and returned; the next tokens come back on the tokens'
    shards.  The attention kernels see local, plain tensors (on a mesh of
    size-1 axes, the whole tensors)."""
    from ..distributed import sharding as shd
    from ..distributed.act_sharding import activation_policy, constrain
    step = make_decode_step(model, cfg)
    pshard = shd.param_shardings(model.abstract_ptree(), mesh)
    tok_shard = shd.data_shardings(input_specs["tokens"], mesh)
    cache_shard = shd.cache_shardings(input_specs["caches"], mesh)
    extra_shard = shd.data_shardings(input_specs.get("extra", {}), mesh)
    rep = shd.replicated(mesh)

    @torch.no_grad()
    def run(params, tokens, caches, cache_len, extra=None):
        params = shd.place_tree(params, pshard)
        tokens = shd.place_tree(tokens, tok_shard)
        caches = shd.place_tree(caches, cache_shard)
        extra = shd.place_tree(extra or {}, extra_shard)
        if not isinstance(cache_len, torch.Tensor):
            cache_len = torch.tensor(cache_len, dtype=torch.int32,
                                     device=tokens.device)
        cache_len = shd.place_tree(cache_len, rep)
        with activation_policy(mesh):
            if cache_len.dim() == 0:          # one depth for every slot
                cache_len = cache_len.expand(tokens.shape[0])
            cache_len = constrain(cache_len, ("batch",))
            nxt, caches = step(params, tokens, caches, cache_len, extra)
            nxt = nxt.redistribute(mesh, tok_shard.placements)
        return nxt, caches
    return run


def ngram_propose(history: torch.Tensor, lengths: torch.Tensor, *,
                  k: int, n: int) -> torch.Tensor:
    """Draft ``k`` continuation tokens a slot from its own token history,
    as :func:`repro.serve.engine.ngram_propose` does: no draft model, a
    prompt and output lookup.

    ``history`` [B, S] holds each slot's known tokens (the prompt, then
    every committed output token); position ``lengths[b]`` is the current
    token, and nothing past it is read.  The tail ``n``-gram ``history[b,
    L-n+1 .. L]`` is matched against every earlier window; the most recent
    match, at start ``p``, gives a period ``d = (L - n + 1) - p``, and the
    draft extrapolates it: position ``L + 1 + t`` copies ``L + 1 + t - d``,
    from the history when that is at most ``L``, else from an earlier
    draft of this call.  No match gives ``d = 1``: repeat the current
    token.  Returns [B, k] in the history's dtype, on its device, with no
    host read (so it can be captured in a CUDA graph)."""
    b, s = history.shape
    dev = history.device
    ln = lengths.to(torch.int64)
    idx = torch.arange(s, device=dev)
    match = torch.ones((b, s), dtype=torch.bool, device=dev)
    for j in range(n):
        shifted = history[:, torch.clamp(idx + j, max=s - 1)]      # [B, S]
        tail_j = torch.gather(
            history, 1, torch.clamp(ln - n + 1 + j, 0, s - 1)[:, None])
        match &= shifted == tail_j
    # candidate starts: the window lies wholly below the tail's own, so
    # the continuation position p + n is a known token (p <= L - n)
    valid = idx[None, :] <= (ln - n)[:, None]
    p = torch.where(match & valid, idx[None, :], -1).amax(dim=1)    # [B]
    d = torch.where(p >= 0, ln - n + 1 - p, 1)                      # >= 1
    drafts: list[torch.Tensor] = []
    for t in range(k):
        src = ln + 1 + t - d                                        # [B]
        from_hist = torch.gather(history, 1,
                                 torch.clamp(src, 0, s - 1)[:, None])[:, 0]
        if drafts:
            prev = torch.stack(drafts, dim=1)                       # [B, t]
            from_draft = torch.gather(
                prev, 1, torch.clamp(t - d, 0, t - 1)[:, None])[:, 0]
        else:
            from_draft = from_hist
        drafts.append(torch.where(src <= ln, from_hist, from_draft))
    return torch.stack(drafts, dim=1)                               # [B, k]


def _within(policy: DecodeAttnPolicy | None, cfg: ServeConfig, fn):
    """``fn`` run inside ``policy`` (None: a policy of mode
    ``cfg.attn_mode``, its tuned launches loaded now)."""
    if policy is None:
        policy = DecodeAttnPolicy(mode=cfg.attn_mode)

    def run(*args):
        with decode_attn_policy(policy):
            return fn(*args)
    return run


def make_decode_loop(model: Model, cfg: ServeConfig, *, steps: int,
                     eos_id: int | None, kv_cap: int | None = None,
                     paged: bool = False, speculate_k: int = 0,
                     policy: DecodeAttnPolicy | None = None):
    """Build the multi-token decode driver.  The loop runs inside
    ``policy`` (None: one of mode ``cfg.attn_mode``, its tuned launches
    loaded now).

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
    case, or optimistic admission grew each decoding slot's table over the
    segment's advance before it), and the slice plays ``kv_cap``'s
    role.

    With ``speculate_k`` = k > 0 (paged and greedy only) each step is a
    draft-k verify step, as in JAX's ``spec_loop``: ``loop(params, tok,
    caches, lengths, done, remaining, gen, history, pages)``, where
    ``history`` [B, max_len + 1] int32 holds each slot's known tokens
    (position ``lengths[b]`` the current one) and is written in place.  Its
    last column is no position: it takes the writes JAX drops (``mode=
    "drop"``), and the drafter reads the first ``max_len`` columns only.
    :func:`ngram_propose` drafts k tokens, one ``decode_step`` at Lq = k+1
    at depth ``lengths`` gives the model's greedy token at every position,
    and a slot commits the longest prefix of drafts that agree plus the
    model's bonus token (1 to k+1 tokens), cut at an EOS inside the
    window, the remaining budget and ``max_len``.  ``lengths`` advances by
    the committed count: the K/V rows written past it are overwritten by
    the next verify (rollback by not advancing; admission reserved the
    k-token overhang).  ``emitted`` is [steps, B, k+1] with PAD_TOKEN past
    each step's committed count."""
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

    if not speculate_k:
        return _within(policy, cfg, loop)
    if not paged:
        raise ValueError("speculate_k requires the paged loop")
    k, spec_n = speculate_k, cfg.speculate_ngram

    def spec_loop(params, tok, caches, lengths, done, remaining, gen,
                  history, pages):
        state = (tok, lengths, done, remaining)
        corpus = history[:, :cfg.max_len]          # the drafter's view
        dev = tok.device
        jidx = torch.arange(k + 1, device=dev)[None, :]
        rows = torch.arange(tok.shape[0], device=dev)[:, None].expand(
            -1, k + 1)
        emitted = []
        for _ in range(steps):
            drafts = ngram_propose(corpus, lengths, k=k, n=spec_n)
            qtok = torch.cat([tok, drafts], dim=1)                 # [B, k+1]
            # Lq = k+1 at per-slot depth ``lengths``: K/V written at
            # lengths .. lengths + k, causal attention through the pages
            logits, caches = model.decode_step(
                params, qtok, caches, lengths, dtype=cfg.dtype, pages=pages)
            out = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            # accepted: the longest prefix of drafts equal to the model's
            # own greedy token one position earlier; commit them and the
            # model's bonus token after them
            agree = (drafts == out[:, :-1]).to(torch.int32)        # [B, k]
            adv = (torch.cumprod(agree, dim=1).sum(dim=1) + 1).to(
                torch.int32)                                       # 1..k+1
            if eos_id is not None:
                hit = out == eos_id
                first_eos = torch.argmax(hit.to(torch.int32), dim=1)
                adv = torch.minimum(adv, torch.where(
                    hit.any(dim=1), first_eos + 1, k + 1).to(torch.int32))
            adv = torch.minimum(adv, remaining)            # token budget
            adv = torch.minimum(adv, cfg.max_len - lengths)  # window cap
            adv = torch.where(done, 0, adv)
            commit = jidx < adv[:, None]                           # [B, k+1]
            emitted.append(torch.where(commit, out, PAD_TOKEN))
            last = torch.gather(out, 1,
                                (adv - 1).clamp_min(0)[:, None].long())
            # committed token j becomes known history at lengths + 1 + j
            # (position lengths holds the current token); the rest, and a
            # commit at max_len, go to the spare column
            wpos = torch.where(commit, lengths[:, None] + 1 + jidx,
                               cfg.max_len).clamp(max=cfg.max_len)
            history[rows, wpos] = out
            if eos_id is None:
                eos_last = torch.zeros_like(done)
            else:
                # an EOS inside the window cut adv at itself, so if it was
                # committed at all it is the last committed token
                eos_last = (last[:, 0] == eos_id) & (adv > 0)
            remaining = remaining - adv
            lengths = lengths + adv
            new_done = (done | eos_last | (remaining <= 0)
                        | (lengths >= cfg.max_len))
            tok = torch.where((adv > 0)[:, None], last, tok)
            done = new_done
        for held, final in zip(state, (tok, lengths, done, remaining)):
            held.copy_(final)
        return torch.stack(emitted)                       # [steps, B, k+1]
    return _within(policy, cfg, spec_loop)


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
    must pass the same state, cache and page tensors (and, for the
    speculative loop, the same token history): a call with one rebound
    raises.  With ``sampled`` (a temperature above 0) the
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
                 *rest) -> torch.Tensor:
        """``rest`` is what the loop takes after ``gen``: nothing (dense),
        ``(pages,)`` (paged) or ``(history, pages)`` (speculative)."""
        args = (params, tok, caches, lengths, done, remaining, gen) + rest
        at = _addresses(args[1:])
        if self.graph is not None:
            if at != self._captured_at:
                raise RuntimeError(
                    "a decode graph was called with tensors other than "
                    "the ones it was captured with: the slot state, the "
                    "caches, the page table and the token history must be "
                    "written in place")
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


def make_join(model: Model, cfg: ServeConfig, *, eos_id: int | None,
              policy: DecodeAttnPolicy | None = None):
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
    graph captured over those tensors reads the joined rows; so are an SSM
    segment's conv window and state, whose joining rows are copied whole
    (each row's prefill started from zero and stopped at its own prompt
    length, see :mod:`repro_torch.models.ssm`).  Returns
    (caches, tok, lengths, done, remaining, first), the same tensors it
    was given and ``first`` [J], the joining rows' first sampled
    tokens.  The join runs inside ``policy``, as the decode loop does."""
    temp = cfg.temperature

    def join(params, caches, tok, lengths, done, remaining, rows, prompts,
             plens, budgets, gen):
        b, width = tok.shape[0], prompts.shape[1]
        last, fresh = model.prefill(
            params, {"tokens": prompts.new_zeros((b, width)).index_copy(
                0, rows, prompts)}, width, dtype=cfg.dtype,
            last_pos=plens.new_zeros(b).index_copy(0, rows, plens - 1),
            logits=False)
        for new, old in zip(fresh, caches):
            for name, held in old.items():
                # stripes: the prompt's rows; an SSM leaf whole
                cut = width if name in ("k", "v") else None
                held[:, :, :cut].index_copy_(
                    1, rows, new[name][:, :, :cut].index_select(1, rows))
        with part("readout"):
            logits = model.readout(params, last)[rows]
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
    return _within(policy, cfg, join)


def rows_interact(cfg: ArchConfig) -> bool:
    """Whether a row of one model call can change another row's values:
    true when a routed-expert segment (``BlockKind.MOE``) can drop, that
    is ``top_k x capacity_factor < n_experts``.  Its capacity ``int(T k
    cf / E)`` counts every row and position of the call, so the rows
    sharing a call decide which choices drop.  At ``k cf >= E`` it is at
    least T, a place for every token an expert can take (a token picks an
    expert once), so nothing drops: a dropless MoE (DeepSeek-V3's) is per
    row, as attention (GQA, MLA), dense MLPs and SSM recurrences are."""
    m = cfg.moe
    return (m is not None and m.top_k * m.capacity_factor < m.n_experts
            and any(seg.kind is BlockKind.MOE
                    for seg in cfg.resolved_segments()))


# rows x width of one prefill call of a join whose rows do not interact:
# a wider join runs its rows in consecutive calls of at most this many
# tokens (one row at least), so its activations stay bounded
JOIN_CALL_TOKENS = 8192


def make_paged_join(model: Model, cfg: ServeConfig, *, eos_id: int | None,
                    policy: DecodeAttnPolicy | None = None):
    """Paged slot refill: prefill the joining slots' pieces through their
    page tables into the shared pool, sample the first tokens of the rows
    whose prompt completes, and write the slot state back by slot index.

    ``join(params, caches, tok, lengths, done, remaining, rows, prompts,
    plens, budgets, gen, pages, prefix_lens, commit)``: ``rows`` [J]
    int64 names the joining slots, and ``prompts`` [J, W], ``plens``,
    ``budgets``, ``prefix_lens`` (each row's resident depth, 0 for a
    whole-prompt prefill) and ``commit`` (the rows whose prompt completes
    with this call) [J] and ``pages`` [J, P] (their page tables) are
    theirs, in that order.

    Which rows the prefill computes depends on the model
    (:func:`rows_interact`).  Where no row can change another's values
    (no routed experts, or a dropless MoE) it computes the J joining rows
    alone, in calls of at most ``JOIN_CALL_TOKENS`` rows x width.  Where
    routed experts can drop it computes all B slots in one call, as JAX's
    join does: the experts' capacity counts every row of the call, so
    fewer rows would change which choices drop, and the benchmark's check
    samples only the slots whose choices no B-row join can drop
    (``portbench/check.py::undroppable_slots``).  There the other rows
    take zero prompts and an all-sentinel write table, so their writes
    never reach a live page.  Either way only the joining rows are
    written: every other slot's pages, token, length, flags and SSM
    window and state stay bit-for-bit the same.  SSM segments keep
    per-slot state, not pages, as in JAX: the prefill starts from zeroed
    scratch state (JAX's from the serving state, the previous occupant's
    for a reused slot) and the joining rows' fresh window and state are
    copied into their slots.  A joining row that does not commit (a
    chunk of a longer prompt) keeps its token and is latched done with
    nothing left to emit.  The slot state is written in place
    (``index_copy_``), as in :func:`make_join`, inside ``policy``.
    Returns (caches, tok, lengths, done, remaining, first), the state
    tensors the same ones it was given and ``first`` [J] the joining
    rows' sampled tokens."""
    temp = cfg.temperature
    sentinel = cfg.pool_pages      # the pool's out-of-range id
    recurrent = [seg.kind is BlockKind.SSM
                 for seg in model.cfg.resolved_segments()]
    every_row = rows_interact(model.cfg)

    def prefill(params, caches, call, slots, pick):
        """One prefill call over ``call``'s rows (prompts, plens, depths,
        tables); the fresh SSM window and state of its rows ``pick`` (all
        when None) go to the slots ``slots``.  Returns the last hidden
        rows."""
        c_prompts, c_plens, c_prefix, c_pages = call
        n = c_prompts.shape[0]
        work = [{name: t.new_zeros((t.shape[0], n) + t.shape[2:])
                 for name, t in c.items()} if ssm else c
                for ssm, c in zip(recurrent, caches)]
        last, work = model.prefill_paged(
            params, {"tokens": c_prompts}, work, c_pages, dtype=cfg.dtype,
            last_pos=c_plens - 1, cache_len=c_prefix, logits=False)
        for ssm, new, old in zip(recurrent, work, caches):
            if ssm:           # leaves are [layers, rows, ...]: the row axis
                for name, held in old.items():
                    fresh = new[name]
                    if pick is not None:
                        fresh = fresh.index_select(1, pick)
                    held.index_copy_(1, slots, fresh)
        return last

    def join(params, caches, tok, lengths, done, remaining, rows, prompts,
             plens, budgets, gen, pages, prefix_lens, commit):
        call = (prompts, plens, prefix_lens, pages)
        if every_row:          # the B-row call; other slots write nothing
            b = tok.shape[0]
            call = tuple(x.new_full((b,) + x.shape[1:], fill).index_copy(
                0, rows, x) for x, fill in zip(call, (0, 1, 0, sentinel)))
            last = prefill(params, caches, call, rows, rows)
        else:
            step = max(1, JOIN_CALL_TOKENS // prompts.shape[1])
            last = torch.cat([
                prefill(params, caches, tuple(x[i:i + step] for x in call),
                        rows[i:i + step], None)
                for i in range(0, prompts.shape[0], step)])
        with part("readout"):
            first = sample_tokens(model.readout(params, last)[:, -1], temp,
                                  gen)
            if every_row:
                first = first[rows]
        if eos_id is None:
            is_eos = torch.zeros_like(commit)
        else:
            is_eos = first == eos_id
        rem_new = budgets - 1
        tok.index_copy_(0, rows, torch.where(commit[:, None], first[:, None],
                                             tok[rows]))
        lengths.index_copy_(0, rows, prefix_lens + plens)
        done.index_copy_(0, rows, ~commit | is_eos | (rem_new <= 0))
        remaining.index_copy_(0, rows, torch.where(commit, rem_new, 0))
        return caches, tok, lengths, done, remaining, first
    return _within(policy, cfg, join)
