"""Serving engine of the port: the paged join and the device-resident
decode loop, from :mod:`repro.serve.engine` (paged mode only).

The JAX decode loop is one jitted ``lax.scan`` of ``sync_every`` steps;
here it is a Python loop whose state (tokens, caches, per-slot lengths,
done flags, budgets) stays in device tensors, with sampling on the device.
Nothing inside a segment reads a value back to the host: the emitted
tokens are stacked and read once, by the scheduler, per segment.  The KV
pools are updated in place where JAX donates them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.model_zoo import Model

PAD_TOKEN = -1    # emitted-slot sentinel: "slot was already retired"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The paged subset of ``repro.serve.engine.ServeConfig``.  Features
    the port does not serve yet (prefix cache, chunked prefill,
    speculation, optimistic admission, overload control, telemetry) have
    no fields here."""
    max_len: int
    batch: int
    dtype: torch.dtype = torch.bfloat16
    temperature: float = 0.0     # 0 = greedy
    sync_every: int = 8          # decode steps per host sync
    page_size: int = 16          # KV rows per page
    total_pages: int | None = None   # pool size; None -> batch * max pages

    def __post_init__(self):
        if self.max_len <= 0 or self.batch <= 0 or self.page_size <= 0:
            raise ValueError("max_len, batch and page_size must be positive")

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
                     eos_id: int | None):
    """Build the multi-token paged decode driver.

    Returns ``loop(params, tok, caches, lengths, done, remaining, gen,
    pages) -> ((tok, caches, lengths, done, remaining), emitted)`` where
    ``emitted`` is [steps, B] int32 with PAD_TOKEN in retired slots.
    ``pages`` is the [B, P_cap] slice of the page table, constant across
    the segment (admission reserved every slot's worst case).  Per-slot
    ``lengths`` drive the cache writes, RoPE positions and attention
    masks; ``done`` freezes retired slots (EOS, budget or ``max_len``)."""
    temp = cfg.temperature

    def loop(params, tok, caches, lengths, done, remaining, gen, pages):
        emitted = []
        for _ in range(steps):
            logits, caches = model.decode_step(
                params, tok, caches, lengths, dtype=cfg.dtype, pages=pages)
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
        return (tok, caches, lengths, done, remaining), torch.stack(emitted)
    return loop


def make_paged_join(model: Model, cfg: ServeConfig, *, eos_id: int | None):
    """Paged slot refill.  The batch prefill writes through the page
    table, and rows outside ``join_mask`` get an all-sentinel table, so
    their writes never reach a live page: occupied slots' pages stay
    bit-for-bit intact in the shared pool.  ``prefix_lens`` [B] is each
    joining row's resident depth (0 for a whole-prompt prefill) and
    ``commit_mask`` [B] the joining rows whose prompt completes with this
    call (``commit_mask == join_mask`` when prompts are not chunked).
    Returns (caches, tok, lengths, done, remaining, first)."""
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
        tok = torch.where(commit_mask[:, None], first[:, None], tok)
        lengths = torch.where(join_mask, prefix_lens + plens, lengths)
        remaining = torch.where(commit_mask, rem_new,
                                torch.where(join_mask, 0, remaining))
        done = torch.where(commit_mask, is_eos | (rem_new <= 0),
                           join_mask | done)
        return caches, tok, lengths, done, remaining, first
    return join
