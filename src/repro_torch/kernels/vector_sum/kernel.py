"""Build, load and launch the hand-written CUDA vector-sum kernel.

Sources live in ``csrc/``: ``vector_sum.cu`` (replaces the TPU kernel
``repro/kernels/vector_sum/kernel.py::vector_sum_2d``) and
``binding.cpp``, the one file that includes PyTorch's headers.  They are
compiled for ``sm_90a`` with ``torch.utils.cpp_extension.load`` at the
first launch, into ``build/vector_sum`` at the repository root.
Importing this module builds nothing.

What bounds the kernel on an H100 is device-memory bytes (two arrays in,
one out, one add an element).  The design (``vector_sum.cu``'s header)
is a pure stream: rows of ``THREADS`` 16-byte chunks, one CTA for every
contiguous span of ``UNROLL`` rows, ``UNROLL`` loads of a and of b in
flight a thread before its first store, streaming loads and evict-first
stores.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take; it allocates the output with
``torch.empty`` and launches on PyTorch's current stream.  The plain
version lives in :mod:`.ref` and the routing by the tensors' device in
:mod:`.ops`.  ``launch_counts`` counts launches.
"""
from __future__ import annotations

import pathlib
import threading

import torch

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "vector_sum.cu")
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
THREADS = 512                       # 16-byte chunks of a row (kThreads)
UNROLL = 8                          # rows of a span (kUnroll)

launch_counts = {"vector_sum": 0}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_dir() -> pathlib.Path:
    # <repo>/src/repro_torch/kernels/vector_sum/csrc -> <repo>/build
    return _CSRC.parents[4] / "build" / "vector_sum"


def load_extension():
    """Compile (first call) and load the kernel's extension module."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)   # load() does not
            _ext = load(
                name="repro_torch_vector_sum",
                sources=[str(_CSRC / s) for s in _SOURCES],
                build_directory=str(out),
                extra_cuda_cflags=["-O3", "-std=c++17",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                extra_cflags=["-O3"])
    return _ext


def _check(name: str, t: torch.Tensor, dtypes, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vector_sum_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  a, b of one shape and dtype (float32, bfloat16
    or float16), contiguous, on the card; any shape, at any element
    offset.  One CTA for every span of ``UNROLL`` rows.  Returns a + b,
    equal bit for bit to PyTorch's."""
    _check("a", a, _DTYPES, a.device)
    _check("b", b, (a.dtype,), a.device)
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    if a.numel():                    # empty: nothing to launch
        load_extension().vector_sum(a, b, out)
        launch_counts["vector_sum"] += 1
    return out
