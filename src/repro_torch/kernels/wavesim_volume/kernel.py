"""Build, load and launch the hand-written CUDA wavesim-volume kernel.

Sources live in ``csrc/``: ``volume.cu`` (replaces the TPU kernel
``repro/kernels/wavesim_volume/kernel.py::volume_kernel``) and
``binding.cpp``, the one file that includes PyTorch's headers.  They are
compiled for ``sm_90a`` with ``torch.utils.cpp_extension.load`` at the
first launch, into ``build/wavesim_volume`` at the repository root.
Importing this module builds nothing.

The operator ``W`` is a launch constant: the kernel takes its 729 values
by value among its parameters (the GPU's constant bank), the analogue of
the TPU kernel's resident ``W`` block and of the paper's operator entries
broadcast as immediates.  So the wrapper takes ``W`` as a CPU tensor; it
checks device, dtype, shape and contiguity and raises on anything the
kernel does not take, allocates the output with ``torch.empty`` and
launches on PyTorch's current stream.  The plain version lives in
:mod:`.ref` and the routing by the tensor's device in :mod:`.ops`.
``launch_counts`` counts launches.
"""
from __future__ import annotations

import pathlib
import threading

import numpy as np
import torch

from repro_torch.core.primitives.wavesim import NODES

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "volume.cu")
_DTYPES = (torch.float32, torch.bfloat16)

launch_counts = {"wavesim_volume": 0}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_dir() -> pathlib.Path:
    # <repo>/src/repro_torch/kernels/wavesim_volume/csrc -> <repo>/build
    return _CSRC.parents[4] / "build" / "wavesim_volume"


def load_extension():
    """Compile (first call) and load the kernel's extension module."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)   # load() does not
            _ext = load(
                name="repro_torch_wavesim_volume",
                sources=[str(_CSRC / s) for s in _SOURCES],
                build_directory=str(out),
                extra_cuda_cflags=["-O3", "-std=c++17",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                extra_cflags=["-O3"])
    return _ext


def fused_operator(c: float = 1.0,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W [27, 27] on the CPU: the sum of the three directional Kronecker
    operators times ``c``, built in float64 exactly as the JAX package
    builds it and then rounded to ``dtype``.  Stored transposed, because
    the kernel computes row-vector @ W, i.e. (W^T u)^T.  It equals the
    leading [27, 27] block of the JAX array, whose other lanes are the
    TPU layout's zero padding."""
    d = np.array([[-1.5, 2.0, -0.5],       # = reference_operator
                  [-0.5, 0.0, 0.5],
                  [0.5, -2.0, 1.5]], dtype=np.float64)
    eye = np.eye(3)
    w = (np.kron(np.kron(d, eye), eye)
         + np.kron(np.kron(eye, d), eye)
         + np.kron(np.kron(eye, eye), d))
    w = c * w
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(dtype)


def _check(name: str, t: torch.Tensor, dtypes, device_type: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != device_type:
        raise ValueError(f"{name} must be a {device_type.upper()} tensor, "
                         f"got {t.device}")
    if t.dim() != 2 or t.shape[1] != NODES:
        raise ValueError(f"{name} must be [*, {NODES}], got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def volume_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  x [R, 27] float32 or bfloat16 on the card (the
    element x field rows of u, read in place), w [27, 27] in x's dtype on
    the CPU.  Returns x @ w [R, 27], summed in float32, in x's dtype."""
    _check("x", x, _DTYPES, "cuda")
    _check("w", w, (x.dtype,), "cpu")
    if w.shape[0] != NODES:
        raise ValueError(f"w must be [{NODES}, {NODES}], got "
                         f"{tuple(w.shape)}")
    out = torch.empty_like(x)
    if x.shape[0]:                   # no rows: nothing to launch
        load_extension().volume(x, w.to(torch.float32), out)
        launch_counts["wavesim_volume"] += 1
    return out
