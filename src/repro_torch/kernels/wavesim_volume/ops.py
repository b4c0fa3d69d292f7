"""Public volume op, from :mod:`repro.kernels.wavesim_volume.ops`:
[E, F, 3, 3, 3] nodal fields -> the volume right-hand side.

Routing is by the tensor's device and nothing else: a CUDA ``u`` goes to
the hand-written kernel (:mod:`.kernel`), a CPU ``u`` to its plain version
(:mod:`.ref`).  There is no fallback: a CUDA call the kernel cannot take
raises.  The kron fusion uses index order i-major: flattening [3, 3, 3] in
C order gives node index ``i*9 + j*3 + k``, which matches the layout of
``kron(D_i, D_j, D_k)``.  The JAX op pads each 27-node row to 32 lanes
for the TPU; the kernel reads the 27-wide rows in place, so nothing is
padded or copied.  The fused operator and its 7-point stencil are built
and checked once for each (c, dtype) (:func:`operator`), not on every
call.  There is no ``interpret`` flag.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.primitives.wavesim import NODES

from . import kernel, ref


@functools.lru_cache(maxsize=64)
def operator(c: float, dtype: torch.dtype) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(W, its stencil) for ``c`` and ``dtype``, both on the CPU: W [27,
    27] from :func:`kernel.fused_operator`, the stencil [189] float32 from
    :func:`kernel.stencil_operator`.  Cached; callers must not write to
    them."""
    w = kernel.fused_operator(c, dtype)
    return w, kernel.stencil_operator(w)


def volume(u: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """u [E, F, 3, 3, 3] float32 or bfloat16 -> rhs of u's shape and
    dtype, accumulated in float32 with the fused operator rounded to u's
    dtype (as the JAX op rounds it)."""
    if u.dim() != 5 or tuple(u.shape[2:]) != (3, 3, 3):
        raise ValueError(f"u must be [E, F, 3, 3, 3], got {tuple(u.shape)}")
    x = u.reshape(u.shape[0] * u.shape[1], NODES)
    w, stencil = operator(float(c), u.dtype)
    if u.device.type == "cuda":
        y = kernel.volume_cuda(x, stencil)
    else:
        y = ref.volume_kernel_ref(x, w)
    return y.reshape(u.shape)
