"""Step-by-step reference decode: the port's oracle for the batcher, from
:mod:`repro.serve.reference`.

Every request runs in one padded batch, one ``model.decode_step`` per
token, with host-side bookkeeping and no scheduling.  Each slot owns a
fixed run of pages (an identity page table), so nothing here shares the
batcher's allocator, admission, refill or page-cap bucketing.  Per-slot
lengths make each row's output independent of the other rows, so the
batcher's refills must not change any request's tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import ServeConfig, sample_tokens
from ..models.model_zoo import Model


def reference_decode(model: Model, params, cfg: ServeConfig,
                     requests: list[tuple[int, list[int]]], max_new: int,
                     eos_id: int | None = None,
                     seed: int = 0) -> dict[int, list[int]]:
    """Decode ``requests`` [(rid, prompt)] as one batch, step by step.

    Same per-slot semantics as the engine: padded batch prefill with
    per-row last-prompt-position logits, per-slot cache lengths during
    decode, EOS kept then the slot frozen.  Sampling draws from a
    generator seeded with ``seed`` (unused when greedy)."""
    dev = params["embed"]["table"].device
    b = len(requests)
    width = max(len(p) for _, p in requests)
    toks = np.zeros((b, width), np.int32)
    plens = np.zeros((b,), np.int32)
    for i, (_, p) in enumerate(requests):
        toks[i, :len(p)] = p
        plens[i] = len(p)
    per_slot = -(-(width + max_new) // cfg.page_size)
    table = torch.arange(b * per_slot, dtype=torch.int32,
                         device=dev).reshape(b, per_slot)
    caches = model.init_paged_caches(b, b * per_slot, cfg.page_size,
                                     cfg.dtype, device=dev)
    logits, caches = model.prefill_paged(
        params, {"tokens": torch.as_tensor(toks, device=dev)}, caches, table,
        dtype=cfg.dtype, last_pos=torch.as_tensor(plens - 1, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = sample_tokens(logits[:, -1], cfg.temperature, gen)[:, None]
    lengths = torch.as_tensor(plens, device=dev)
    outs = [[int(tok[i, 0])] for i in range(b)]
    done = [eos_id is not None and outs[i][0] == eos_id or max_new <= 1
            for i in range(b)]
    for _ in range(max_new - 1):
        if all(done):
            break
        logits, caches = model.decode_step(params, tok, caches, lengths,
                                           dtype=cfg.dtype, pages=table)
        nxt = sample_tokens(logits[:, -1], cfg.temperature,
                            gen).cpu().numpy()
        new_tok = tok.cpu().numpy().copy()
        adv = np.zeros((b,), np.int32)
        for i in range(b):
            if done[i]:
                continue
            v = int(nxt[i])
            outs[i].append(v)
            new_tok[i, 0] = v
            adv[i] = 1
            if ((eos_id is not None and v == eos_id)
                    or len(outs[i]) >= max_new):
                done[i] = True
        tok = torch.as_tensor(new_tok, device=dev)
        lengths = lengths + torch.as_tensor(adv, device=dev)
    return {rid: outs[i] for i, (rid, _) in enumerate(requests)}
