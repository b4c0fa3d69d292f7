"""Train-step factory: loss and gradients, float32 microbatch
accumulation, optional int8 error-feedback compression and AdamW, from
:mod:`repro.train.train_loop`.

The state is ``{"params", "opt": {"mu", "nu", "step"}, "ef"}`` (``ef``
None without compression), the layout of JAX's, so checkpoints and the
weight bridge carry it across.  A batch is ``{"tokens": [B, L]}``, or
``[accum, B / accum, L]`` when accumulating (:func:`split_microbatches`).
Gradients come from ``torch.autograd.grad`` on detached views of the
params (no ``.grad`` fields, no copies) and are accumulated in float32,
then scaled by ``1 / accum``, as is the loss.

On a mesh (:func:`sharded_train_step`, JAX's ``jit_train_step``) the
state is placed by :func:`state_shardings` (params and moments by
``param_shardings``, the step replicated) and the batch by
:func:`batch_shardings`, and the step runs under the mesh's activation
policy: the gradients come back as DTensors on the params' shards and
AdamW updates the sharded state in place, where JAX donates it.
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
                           if g is None else _unnest(g).float()
                           for p, g in zip(flat, grads)]


def _unnest(g):
    """A DTensor gradient whose local tensor is itself a DTensor (what
    torch 2.11's non-reentrant checkpoint returns over DTensor ops) as
    one DTensor on its innermost local tensor; other tensors as given."""
    while hasattr(g, "to_local") and hasattr(g.to_local(), "to_local"):
        inner = g.to_local()
        g = type(g).from_local(inner.to_local(), g.device_mesh, g.placements,
                               run_check=False, shape=g.shape,
                               stride=g.stride())
    return g


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


def state_shardings(model: Model, cfg: TrainConfig, mesh) -> dict:
    """The train state's shardings: params and moments (and the error
    feedback) by ``param_shardings``, the step replicated."""
    from ..distributed import sharding as shd
    pshard = shd.param_shardings(model.abstract_ptree(), mesh)
    return {"params": pshard,
            "opt": {"mu": pshard, "nu": pshard,
                    "step": shd.replicated(mesh)},
            "ef": pshard if cfg.compress_grads else None}


def batch_shardings(batch_specs: dict, mesh, accum: int) -> dict:
    """Batch arrays are [accum, mb, ...] when accumulating: dim1 =
    batch."""
    from ..distributed import sharding as shd
    return shd.data_shardings(batch_specs, mesh,
                              batch_dim=1 if accum > 1 else 0)


def sharded_train_step(model: Model, cfg: TrainConfig, mesh,
                       batch_specs: dict):
    """JAX's ``jit_train_step`` on a torch ``DeviceMesh``: ``step(state,
    batch) -> (state, metrics)`` with the state placed by
    :func:`state_shardings` and the batch (``batch_specs``' shapes, split
    into microbatches when accumulating) by :func:`batch_shardings`;
    inputs that are not DTensors yet are placed first.  The state is
    updated in place; ``loss``, ``grad_norm`` and ``lr`` come back
    replicated."""
    from ..distributed import sharding as shd
    from ..distributed.act_sharding import activation_policy, as_dtensor
    step = make_train_step(model, cfg)
    sshard = state_shardings(model, cfg, mesh)
    bshard = batch_shardings(split_microbatches(batch_specs, cfg.accum),
                             mesh, cfg.accum)
    rep = shd.replicated(mesh).placements

    def run(state, batch):
        state = shd.place_tree(state, sshard)
        batch = shd.place_tree(batch, bshard)
        with activation_policy(mesh):
            state, metrics = step(state, batch)
            metrics = {k: as_dtensor(v, mesh).redistribute(mesh, rep)
                       for k, v in metrics.items()}
        return state, metrics
    return run
