"""Weight bridge: the JAX ``init_lm`` tree, as numpy arrays, to the port.

The caller unwraps the JAX tree (``repro.models.param.unwrap``) and turns
every leaf into a numpy array (``np.asarray``); this module imports no
JAX.  The layout is kept as it is: the layer-stacked ``segments`` leaves
stay ``[n_layers, ...]`` and every projection of the port reads them the
way the JAX model's einsums do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def params_from_numpy(tree, *, device: str | torch.device = "cuda"):
    """Nested dicts / lists / tuples of numpy arrays -> the same structure
    of torch tensors on ``device`` (dtypes kept)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        # a copy: arrays exported from JAX are read-only
        return torch.from_numpy(np.array(node, copy=True)).to(dev)
    return conv(tree)
