"""Train-step factory: loss and gradients, float32 microbatch
accumulation, optional int8 error-feedback compression and AdamW, from
:mod:`repro.train.train_loop`.

The state is ``{"params", "opt": {"mu", "nu", "step"}, "ef"}`` (``ef``
None without compression), the layout of JAX's, so checkpoints and the
weight bridge carry it across.  A batch is ``{"tokens": [B, L]}``, or
``[accum, B / accum, L]`` when accumulating (:func:`split_microbatches`).
Gradients come from ``torch.autograd.grad`` on detached views of the
params (no ``.grad`` fields, no copies) and are accumulated in float32,
then scaled by ``1 / accum``, as is the loss.  Not ported (the sharding
slice): ``state_shardings``, ``batch_shardings`` and ``jit_train_step``.
"""
from __future__ import annotations

import dataclasses

import torch

from . import optimizer as opt
from .. import tree
from ..device import resolve_device
from ..distributed.compression import compress_tree
from ..models.model_zoo import Model


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.OptConfig = opt.OptConfig()
    accum: int = 1                   # microbatches per step
    remat: bool = True
    dtype: torch.dtype = torch.bfloat16          # activation dtype
    param_dtype: torch.dtype = torch.float32
    compress_grads: bool = False     # int8 error-feedback compression


def make_train_state(model: Model, seed: int, cfg: TrainConfig, *,
                     device: str | torch.device = "cuda",
                     params: dict | None = None) -> dict:
    """Params (seeded init on ``device``, or the given ``params``, used as
    they are), zero moments and step 0, and zero error feedback when
    compressing."""
    if params is None:
        params = model.init(seed, device=resolve_device(device))
    if cfg.param_dtype != torch.float32:
        params = tree.tree_map(
            lambda x: x.to(cfg.param_dtype)
            if x.dtype == torch.float32 else x, params)
    state = {"params": params, "opt": opt.init_state(params, cfg.opt),
             "ef": None}
    if cfg.compress_grads:
        state["ef"] = tree.tree_map(torch.zeros_like, params)
    return state


def split_microbatches(batch: dict, accum: int) -> dict:
    """[B, ...] -> [accum, B / accum, ...] for every array of ``batch``."""
    if accum == 1:
        return batch
    return {k: x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))
            for k, x in batch.items()}


def loss_and_grads(model: Model, params, batch: dict, cfg: TrainConfig):
    """(loss, float32 gradients in :func:`repro_torch.tree.leaves` order)
    of one microbatch; a leaf the loss does not reach gets zeros."""
    flat = tree.leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    loss = model.loss(tree.unflatten(params, live), batch, dtype=cfg.dtype,
                      remat=cfg.remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p, dtype=torch.float32)
                           if g is None else g.float()
                           for p, g in zip(flat, grads)]


def make_train_step(model: Model, cfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "grad_norm", "lr"}`` as 0-d float32 tensors.  The params
    and moments are updated in place."""

    def grads_fn(params, batch):
        micros = ([batch] if cfg.accum == 1 else
                  [{k: v[i] for k, v in batch.items()}
                   for i in range(cfg.accum)])
        loss_sum, gsum = loss_and_grads(model, params, micros[0], cfg)
        for mb in micros[1:]:
            loss, grads = loss_and_grads(model, params, mb, cfg)
            loss_sum = loss_sum + loss
            for a, g in zip(gsum, grads):
                a.add_(g)
        if cfg.accum > 1:
            inv = 1.0 / cfg.accum
            loss_sum, gsum = loss_sum * inv, [g.mul_(inv) for g in gsum]
        return loss_sum, tree.unflatten(params, gsum)

    def train_step(state, batch):
        loss, grads = grads_fn(state["params"], batch)
        ef = state.get("ef")
        if cfg.compress_grads and ef is not None:
            grads, ef = compress_tree(grads, ef)
        params, opt_state, metrics = opt.apply_updates(
            state["params"], grads, state["opt"], cfg.opt)
        new_state = {"params": params, "opt": opt_state, "ef": ef}
        return new_state, dict(metrics, loss=loss)

    return train_step
