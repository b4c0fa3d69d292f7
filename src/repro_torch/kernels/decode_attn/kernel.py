"""Build, load and launch the hand-written CUDA dense-stripe decode kernel.

Sources live in ``csrc/``: ``decode_attn.cu`` (replaces the TPU kernel
``repro/kernels/decode_attn/kernel.py::decode_attn_kernel``; it runs the
split-KV walk of ``../paged_attn/csrc/decode_split.cuh``, with ``splits``
from :mod:`repro_torch.kernels.paged_attn.split`) and
``binding.cpp``, the one file that includes PyTorch's headers.  They are
compiled for ``sm_90a`` with ``torch.utils.cpp_extension.load`` at the
first launch, into ``build/decode_attn`` at the repository root.
Importing this module builds nothing.

The wrapper checks device, dtype, shape, contiguity, alignment, the group
size and ``s_cap``, and raises on anything the kernel does not take; it
allocates the output with ``torch.empty`` and launches on PyTorch's
current stream.  The plain version lives in :mod:`.ref` and the routing by
the tensors' device in :mod:`.ops`.  ``launch_counts`` counts launches;
``last_splits`` holds the cluster size of the last launch.
"""
from __future__ import annotations

import pathlib
import threading

import torch

from repro_torch.device import sm_count

from ..paged_attn import split

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "decode_attn.cu")
_HEAD_DIMS = (16, 64, 128)     # reduced configs, qwen2-0.5b, moonshot
_DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16                 # kMaxGroup in decode_split.cuh

launch_counts = {"decode_attn": 0}
last_splits = {"decode_attn": None}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_dir() -> pathlib.Path:
    # <repo>/src/repro_torch/kernels/decode_attn/csrc -> <repo>/build
    return _CSRC.parents[4] / "build" / "decode_attn"


def load_extension():
    """Compile (first call) and load the kernel's extension module."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)   # load() does not
            _ext = load(
                name="repro_torch_decode_attn",
                sources=[str(_CSRC / s) for s in _SOURCES],
                build_directory=str(out),
                extra_cuda_cflags=["-O3", "-std=c++17",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                extra_cflags=["-O3"])
    return _ext


def _check(name: str, t: torch.Tensor, ndim: int, dtypes, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or t.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def decode_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, s_cap: int) -> torch.Tensor:
    """Launch the kernel.  q [B, Hq, D]; k/v [B, S, Hkv, D] whole stripes
    in q's dtype; lengths [B] int32; slot b attends over its first
    ``min(lengths[b], s_cap)`` rows, and no row at or past ``s_cap`` is
    read (0 <= s_cap <= S).  One launch of ``split.split_count(B, Hkv,
    G, s_cap, SMs)`` CTAs per (slot, KV head, row group).  Returns [B, Hq,
    D] in q's dtype."""
    dev = q.device
    _check("q", q, 3, _DTYPES, dev)
    _check("k", k, 4, (q.dtype,), dev)
    _check("v", v, 4, (q.dtype,), dev)
    _check("lengths", lengths, 1, (torch.int32,), dev)
    b, hq, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k and v differ in shape: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if k.shape[0] != b or lengths.shape[0] != b:
        raise ValueError(f"k {tuple(k.shape)} and lengths "
                         f"{tuple(lengths.shape)} must have batch {b}")
    s, hkv = k.shape[1], k.shape[2]
    if k.shape[3] != d:
        raise ValueError(f"head_dim {d} of q != {k.shape[3]} of k/v")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} KV heads: the kernel "
                         f"takes groups of 1 to {MAX_GROUP}")
    if not isinstance(s_cap, int) or not 0 <= s_cap <= s:
        raise ValueError(f"s_cap must be an int in [0, {s}], got {s_cap!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "reads rows in 16-byte chunks)")
    splits = split.split_count(b, hkv, hq // hkv, s_cap, sm_count(dev))
    ext = load_extension()
    out = torch.empty_like(q)
    ext.decode_attn(q, k, v, lengths, s_cap, out, splits)
    launch_counts["decode_attn"] += 1
    last_splits["decode_attn"] = splits
    return out
