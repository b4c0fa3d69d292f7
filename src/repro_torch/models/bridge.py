"""Weight bridge: the JAX ``init_lm`` tree, or a whole JAX train state
(``params``, ``opt`` with ``mu``, ``nu`` and ``step``, and ``ef``), as
numpy arrays, to the port.

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
from ..tree import tree_map


def params_from_numpy(tree, *, device: str | torch.device = "cuda"):
    """Nested dicts / lists / tuples of numpy arrays -> the same structure
    of torch tensors on ``device`` (dtypes kept; 0-d arrays, such as the
    optimizer's step, stay 0-d).  ``None`` (a train state's ``ef`` without
    compression) stays ``None``."""
    dev = resolve_device(device)
    # a copy: arrays exported from JAX are read-only
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(
        dev), tree)
