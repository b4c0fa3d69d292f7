"""Build, load and launch the hand-written CUDA face-flux kernel.

Sources live in ``csrc/``: ``flux1d.cu`` (replaces the TPU kernel
``repro/kernels/wavesim_flux/kernel.py::flux1d_kernel``) and
``binding.cpp``, the one file that includes PyTorch's headers.  They are
compiled for ``sm_90a`` with ``torch.utils.cpp_extension.load`` at the
first launch, into ``build/wavesim_flux`` at the repository root.
Importing this module builds nothing.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take; it allocates the outputs with
``torch.empty`` and launches on PyTorch's current stream.  The plain
version lives in :mod:`.ref` and the routing by the tensors' device in
:mod:`.ops`.  ``launch_counts`` counts launches.
"""
from __future__ import annotations

import pathlib
import threading

import torch

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "flux1d.cu")
_DTYPES = (torch.float32, torch.bfloat16)

launch_counts = {"flux1d": 0}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_dir() -> pathlib.Path:
    # <repo>/src/repro_torch/kernels/wavesim_flux/csrc -> <repo>/build
    return _CSRC.parents[4] / "build" / "wavesim_flux"


def load_extension():
    """Compile (first call) and load the kernel's extension module."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)   # load() does not
            _ext = load(
                name="repro_torch_wavesim_flux",
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
    if t.dim() != 2:
        raise ValueError(f"{name} must be [E, T], got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flux1d_cuda(hi: torch.Tensor, lo: torch.Tensor, alpha: float = 0.5
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  hi, lo [E, T] float32 or bfloat16 of one shape
    and dtype on the card.  Returns (fhi, flo) [E, T] in their dtype,
    computed in float32 and rounded once."""
    _check("hi", hi, _DTYPES, hi.device)
    _check("lo", lo, (hi.dtype,), hi.device)
    if lo.shape != hi.shape:
        raise ValueError(f"hi {tuple(hi.shape)} and lo {tuple(lo.shape)} "
                         "differ")
    fhi, flo = torch.empty_like(hi), torch.empty_like(lo)
    if hi.numel():                   # no entries: nothing to launch
        load_extension().flux1d(hi, lo, float(alpha), fhi, flo)
        launch_counts["flux1d"] += 1
    return fhi, flo
