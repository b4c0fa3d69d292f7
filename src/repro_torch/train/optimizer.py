"""AdamW with a warmup-cosine schedule and global-norm clipping, from
:mod:`repro.train.optimizer`, in the same arithmetic order.

The update math runs in float32 and casts back to each leaf's dtype;
``moment_dtype`` (default float32) is the moments' storage.  Decoupled
weight decay goes to every leaf with ``ndim >= 2``: the leaves are
layer-stacked, so stacked norm scales and biases ``[n_layers, d]`` are
decayed too, as in JAX.  The update runs under ``torch.no_grad()`` and
writes params and moments in place (JAX donates the state); the step
counter is a 0-d int32 tensor on the params' device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Learning rate at ``step`` (an int or a 0-d tensor), float32: a
    linear warmup ``(step + 1) / warmup``, then a cosine to 0.1 of
    ``lr`` at ``total_steps``."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp((s + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_state(params, cfg: OptConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,  # noqa
                                  device=p.device)
    first = tree.leaves(params)[0]
    return {"mu": tree.tree_map(zeros, params),
            "nu": tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


def _local(t):
    """A replicated DTensor's local tensor (other tensors as given)."""
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}); the
    params and moments are the given tensors, updated in place, and the
    state's step a new tensor one past the given one.

    Sharded (DTensor params, moments and gradients): the norm is the
    global one, and each leaf's update runs on its local shards (the
    gradient first brought to the param's placements), elementwise as it
    is, so the same arithmetic updates each shard in place."""
    step = _local(state["step"])       # replicated when sharded
    gnorm = global_norm(grads)
    scale = _local(torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                               max=1.0))
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - torch.pow(b1, step.float() + 1.0)
    c2 = 1.0 - torch.pow(b2, step.float() + 1.0)

    def upd(p, g, mu, nu):
        if hasattr(p, "to_local"):
            g = g.redistribute(p.device_mesh, p.placements)
            p, g, mu, nu = (t.to_local() for t in (p, g, mu, nu))
        g = g.float() * scale
        mu32 = mu.float() * b1 + (1 - b1) * g
        nu32 = nu.float() * b2 + (1 - b2) * torch.square(g)
        mhat = mu32 / c1
        vhat = nu32 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        mu.copy_(mu32)
        nu.copy_(nu32)

    tree.tree_map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
