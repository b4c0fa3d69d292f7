"""Build, load and launch the hand-written CUDA hot/cold push-scatter
kernel.

Sources live in ``csrc/``: ``push_scatter.cu`` (replaces the TPU kernel
``repro/kernels/push_scatter/kernel.py::push_scatter_kernel``) and
``binding.cpp``, the one file that includes PyTorch's headers.  They are
compiled for ``sm_90a`` with ``torch.utils.cpp_extension.load`` at the
first launch, into ``build/push_scatter`` at the repository root.
Importing this module builds nothing.

The wrapper checks device, dtype, shape and contiguity and the size of
the hot set, and raises on anything the kernel does not take; it allocates
the outputs with ``torch.empty`` and launches on PyTorch's current stream.
The plain version lives in :mod:`.ref` and the routing by the tensors'
device in :mod:`.ops`.  ``launch_counts`` counts launches.
"""
from __future__ import annotations

import pathlib
import threading

import torch

from .. import launches

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "push_scatter.cu")
MAX_HOT = 48 * 1024 // 4       # float slots in the default 48 KB of smem

launch_counts = {"push_scatter": 0}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_dir() -> pathlib.Path:
    # <repo>/src/repro_torch/kernels/push_scatter/csrc -> <repo>/build
    return _CSRC.parents[4] / "build" / "push_scatter"


def load_extension():
    """Compile (first call) and load the kernel's extension module."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)   # load() does not
            _ext = load(
                name="repro_torch_push_scatter",
                sources=[str(_CSRC / s) for s in _SOURCES],
                build_directory=str(out),
                extra_cuda_cflags=["-O3", "-std=c++17",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                extra_cflags=["-O3"])
    return _ext


def _check(name: str, t: torch.Tensor, dtype, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {t.device}")
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype} is not {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def push_scatter_cuda(dst_hot: torch.Tensor, val: torch.Tensor,
                      hot: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  dst_hot [U] int32: the hot slot of each update,
    or -1; val [U] float32.  Returns (hot_acc [hot], cold_vals [U]), both
    float32: the sum of each slot's values, and each cold value (0 where
    the update is hot)."""
    dev = val.device
    _check("dst_hot", dst_hot, torch.int32, dev)
    _check("val", val, torch.float32, dev)
    if dst_hot.shape != val.shape:
        raise ValueError(f"dst_hot {tuple(dst_hot.shape)} and val "
                         f"{tuple(val.shape)} differ")
    if not isinstance(hot, int) or not 1 <= hot <= MAX_HOT:
        raise ValueError(f"hot must be an int in [1, {MAX_HOT}] (the hot "
                         f"accumulator lives in shared memory), got {hot!r}")
    hot_acc = torch.empty(hot, dtype=torch.float32, device=dev)
    cold = torch.empty_like(val)
    load_extension().push_scatter(dst_hot, val, hot_acc, cold)
    if val.numel():                  # no updates: hot_acc zeroed, no launch
        launches.count(launch_counts, "push_scatter")
    return hot_acc, cold
