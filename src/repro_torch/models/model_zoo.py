"""Model entry point of the port, from :mod:`repro.models.model_zoo`:
:class:`Model` wraps the functional transformer with the arch's config
(inference over dense stripes or paged pools)."""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from .init import init_params
from .transformer import (forward, init_caches, init_paged_caches,
                          logits_fn)


def _last_rows(hidden: torch.Tensor, last_pos) -> torch.Tensor:
    """Each row's hidden state at ``last_pos[b]`` (clipped), [B, 1, D]."""
    if last_pos is None:
        return hidden[:, -1:]
    lp = torch.as_tensor(last_pos, dtype=torch.int64, device=hidden.device)
    lp = lp.clamp(0, hidden.shape[1] - 1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device),
                  lp][:, None]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, seed: int = 0, *, device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        return init_params(self.cfg, seed, device=device, dtype=dtype)

    def prefill(self, params, batch, max_len: int, *, dtype=torch.bfloat16,
                last_pos=None):
        """Run the prompt, filling fresh dense stripes sized for ``max_len``
        tokens on the tokens' device.  ``last_pos`` ([B]) picks each row's
        logits position: prompts of mixed length share one padded prefill,
        and the padding keys are masked out (and later overwritten) by
        per-slot cache lengths during decode.  Returns (logits [B, 1, V]
        float32, caches)."""
        tokens = batch["tokens"]
        caches = init_caches(self.cfg, tokens.shape[0], max_len, dtype,
                             tokens.device)
        hidden, caches = forward(params, batch, self.cfg, caches=caches,
                                 cache_len=0, dtype=dtype)
        return logits_fn(params, _last_rows(hidden, last_pos),
                         self.cfg), caches

    def prefill_paged(self, params, batch, caches, pages, *,
                      dtype=torch.bfloat16, last_pos=None, cache_len=None):
        """Paged prefill: write the prompt's K/V through ``pages`` ([B, P]
        page table) into the pooled ``caches``.  Rows whose table entries
        are all sentinels write nothing to live pages: that is how the
        serving join prefills only the slots being refilled.  ``cache_len``
        ([B] int32, default zeros) makes this a suffix prefill at that
        depth.  ``last_pos`` ([B]) picks each row's logits position.
        Returns (logits [B, 1, V] float32, caches)."""
        b = batch["tokens"].shape[0]
        dev = batch["tokens"].device
        if cache_len is None:
            cache_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        hidden, caches = forward(params, batch, self.cfg, caches=caches,
                                 cache_len=cache_len.to(torch.int32),
                                 dtype=dtype, pages=pages)
        return logits_fn(params, _last_rows(hidden, last_pos),
                         self.cfg), caches

    def decode_step(self, params, tokens, caches, cache_len, *,
                    dtype=torch.bfloat16, pages=None, kv_cap=None):
        """tokens [B, L] against the filled caches at per-slot depth
        ``cache_len``: dense stripes, or paged pools when ``pages`` carries
        the slots' page tables.  L = 1 for decode, L = k+1 for a
        speculative verify.  ``kv_cap`` (dense only) bounds the stripe rows
        a one-token call reads, as the JAX policy's ``kv_cap`` does.  A
        paged call at L > 1 is a verify: its attention goes through
        ``paged_verify_attn``.  Returns (logits [B, L, V] float32,
        caches)."""
        hidden, caches = forward(params, {"tokens": tokens}, self.cfg,
                                 caches=caches, cache_len=cache_len,
                                 dtype=dtype, pages=pages, kv_cap=kv_cap,
                                 verify=pages is not None
                                 and tokens.shape[1] > 1)
        return logits_fn(params, hidden, self.cfg), caches

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16, *,
                    device: str | torch.device = "cuda"):
        return init_caches(self.cfg, batch, max_len, dtype, device)

    def init_paged_caches(self, batch: int, n_pages: int, page_size: int,
                          dtype=torch.bfloat16, *,
                          device: str | torch.device = "cuda"):
        return init_paged_caches(self.cfg, batch, n_pages, page_size, dtype,
                                 device)

