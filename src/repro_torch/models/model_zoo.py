"""Model entry point of the port, from :mod:`repro.models.model_zoo`:
:class:`Model` wraps the functional transformer with the arch's config
(the training loss, and inference over dense stripes or paged pools), and
gives the dry-run its shape-only params and inputs (``abstract_ptree``,
``abstract_params``, ``input_specs``: ``meta`` tensors in place of JAX's
``ShapeDtypeStruct``)."""
from __future__ import annotations

import dataclasses

import torch

from .. import tree
from ..configs.base import ArchConfig, Frontend, ShapeConfig
from . import param as pm
from .init import abstract_ptree, init_params
from .transformer import (forward, init_caches, init_paged_caches,
                          lm_loss, logits_fn)


def _last_rows(hidden: torch.Tensor, last_pos) -> torch.Tensor:
    """Each row's hidden state at ``last_pos[b]`` (clipped), [B, 1, D]."""
    if last_pos is None:
        return hidden[:, -1:]
    lp = torch.as_tensor(last_pos, dtype=torch.int64, device=hidden.device)
    lp = lp.clamp(0, hidden.shape[1] - 1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device),
                  lp][:, None]


def _lengths(last_pos, tokens: torch.Tensor) -> torch.Tensor | None:
    """Each row's prompt length, ``last_pos + 1`` (None: the full call)."""
    if last_pos is None:
        return None
    return torch.as_tensor(last_pos, dtype=torch.int64,
                           device=tokens.device) + 1


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, seed: int = 0, *, device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float32) -> dict:
        return init_params(self.cfg, seed, device=device, dtype=dtype)

    def abstract_ptree(self) -> dict:
        """Shape-only P-tree (``meta`` values, JAX's logical axes kept):
        what :func:`repro_torch.distributed.sharding.param_shardings`
        reads."""
        return abstract_ptree(self.cfg)

    def abstract_params(self, dtype=torch.float32) -> dict:
        """Shape-only unwrapped params (no allocation), float32 leaves in
        ``dtype``: the dry-run's inputs."""
        return tree.tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32
                             else t, pm.unwrap(self.abstract_ptree()))

    def input_specs(self, shape: ShapeConfig, dtype=torch.bfloat16) -> dict:
        """``meta`` stand-ins for every input of the step this shape cell
        runs, as JAX's: train and prefill a ``batch`` (tokens [B, L]
        int32, a vision model's ``vision_embeds`` and an enc-dec's
        ``encoder_frames`` in ``dtype``); decode one token a row
        (``tokens`` [B, 1]) against dense ``caches`` sized for
        ``seq_len`` tokens (:func:`~.transformer.init_caches`, sink row
        included), a 0-d int32 ``cache_len`` and ``extra`` (an enc-dec's
        ``cross_kv``)."""
        cfg = self.cfg
        b = shape.global_batch

        def spec(shp, dt):
            return torch.empty(shp, dtype=dt, device="meta")
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": spec((b, shape.seq_len), torch.int32)}
            if cfg.frontend is Frontend.VISION_STUB:
                batch["vision_embeds"] = spec(
                    (b, cfg.vision_tokens, cfg.d_model), dtype)
            if cfg.enc_dec:
                batch["encoder_frames"] = spec(
                    (b, cfg.encoder_seq, cfg.d_model), dtype)
            return {"batch": batch}
        extra = {}
        if cfg.enc_dec:
            kv = (b, cfg.encoder_seq, cfg.kv_heads, cfg.resolved_head_dim)
            extra["cross_kv"] = (spec(kv, dtype), spec(kv, dtype))
        return {"tokens": spec((b, 1), torch.int32),
                "caches": init_caches(cfg, b, shape.seq_len, dtype, "meta"),
                "cache_len": spec((), torch.int32),
                "extra": extra}

    def loss(self, params, batch, *, dtype=torch.bfloat16,
             remat: bool = False):
        """The float32 training loss of ``batch["tokens"]`` [B, L]
        (:func:`~.transformer.lm_loss`)."""
        return lm_loss(params, batch, self.cfg, dtype=dtype, remat=remat)

    def prefill(self, params, batch, max_len: int, *, dtype=torch.bfloat16,
                last_pos=None, caches=None, logits: bool = True):
        """Run the prompt, filling fresh dense stripes sized for ``max_len``
        tokens on the tokens' device.  ``last_pos`` ([B]) picks each row's
        logits position: prompts of mixed length share one padded prefill,
        and the padding keys are masked out (and later overwritten) by
        per-slot cache lengths during decode; an SSM segment's recurrence
        stops at each row's ``last_pos + 1`` (:func:`_lengths`).  The
        batch may carry ``vision_embeds``, ``encoder_frames`` or
        ``cross_kv`` (see :func:`~.transformer.forward`).  Returns
        (logits [B, 1, V] float32, caches), or with ``logits`` False the
        hidden states the logits read ([B, 1, D]: :meth:`readout`'s
        input).  ``caches`` (zeroed stripes for ``max_len`` tokens, e.g.
        placed on a mesh) are filled in place of fresh ones."""
        tokens = batch["tokens"]
        if caches is None:
            caches = init_caches(self.cfg, tokens.shape[0], max_len, dtype,
                                 tokens.device)
        hidden, caches = forward(params, batch, self.cfg, caches=caches,
                                 cache_len=0, dtype=dtype,
                                 lengths=_lengths(last_pos, tokens))
        last = _last_rows(hidden, last_pos)
        return (self.readout(params, last) if logits else last), caches

    def readout(self, params, hidden):
        """Logits (float32) of hidden states [..., D]."""
        return logits_fn(params, hidden, self.cfg)

    def prefill_paged(self, params, batch, caches, pages, *,
                      dtype=torch.bfloat16, last_pos=None, cache_len=None,
                      logits: bool = True):
        """Paged prefill: write the prompt's K/V through ``pages`` ([B, P]
        page table) into the pooled ``caches``.  Rows whose table entries
        are all sentinels write nothing to live pages: that is how the
        serving join of a MoE model whose experts can drop, which computes
        every slot, refills only the joining ones (any other model's join
        hands in the joining rows alone).  ``cache_len``
        ([B] int32, default zeros) makes this a suffix prefill at that
        depth.  ``last_pos`` ([B]) picks each row's logits position, and
        ends each row's SSM recurrence there, as in :meth:`prefill`; the
        SSM caches given take every row's fresh state (the paged join
        hands in scratch state and keeps the joining rows').  Returns
        (logits [B, 1, V] float32, caches), or with ``logits`` False the
        hidden states the logits read ([B, 1, D])."""
        b = batch["tokens"].shape[0]
        dev = batch["tokens"].device
        if cache_len is None:
            cache_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        hidden, caches = forward(params, batch, self.cfg, caches=caches,
                                 cache_len=cache_len.to(torch.int32),
                                 dtype=dtype, pages=pages,
                                 lengths=_lengths(last_pos, batch["tokens"]))
        last = _last_rows(hidden, last_pos)
        return (self.readout(params, last) if logits else last), caches

    def decode_step(self, params, tokens, caches, cache_len, *,
                    dtype=torch.bfloat16, extra: dict | None = None,
                    pages=None, kv_cap=None):
        """tokens [B, L] against the filled caches at per-slot depth
        ``cache_len``: dense stripes, or paged pools when ``pages`` carries
        the slots' page tables.  L = 1 for decode, L = k+1 for a
        speculative verify.  ``kv_cap`` (dense only) bounds the stripe rows
        a one-token call reads, as the JAX policy's ``kv_cap`` does.  A
        paged call at L > 1 is a verify: its attention goes through
        ``paged_verify_attn``.  ``extra`` joins the batch, as in JAX:
        an encoder-decoder's ``{"cross_kv": (k, v)}`` from
        :func:`~.transformer.encode`.  Returns (logits [B, L, V] float32,
        caches)."""
        batch = {"tokens": tokens}
        if extra:
            batch.update(extra)
        hidden, caches = forward(params, batch, self.cfg,
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

