"""Build, load and launch the hand-written CUDA grouped expert GEMM.

Sources live in ``csrc/``: ``group_gemm.cu`` (replaces the TPU kernel
``repro/kernels/moe_group_gemm/kernel.py::group_gemm_kernel``: decode
and float32, and the launcher), ``group_gemm_sm90.cu`` (the same kernel
for bfloat16 slabs of more than 16 rows, a join's: wgmma fed by TMA) and
``binding.cpp``, the one file that includes PyTorch's headers.  They are
compiled for ``sm_90a`` with ``torch.utils.cpp_extension.load`` at the
first launch, into ``build/moe_group_gemm`` at the repository root.
Importing this module builds nothing.

The wrapper checks device, dtype, shape, contiguity and alignment (rows of
D and F in whole 16 bytes, 16-byte aligned bases) and raises on anything
the kernel does not take; it allocates the output with ``torch.empty`` and
launches on PyTorch's current stream.  The tile is :func:`tile_rows`
capacity rows by :func:`tile_cols` output columns: 16 x 64 where C fits
one fragment (as at decode), 256 x 128 for bfloat16 past that (the wgmma
kernel), 64 x 64 for float32.  Given ``tiles``, the kernel counts on the
card the tiles it ran and those it skipped; :func:`tile_counts` is what
the tiling rule predicts.
The plain version lives in :mod:`.ref` and the routing by the tensors'
device in :mod:`.ops`.  ``launch_counts`` counts launches.
"""
from __future__ import annotations

import pathlib
import threading

import torch

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "group_gemm.cu", "group_gemm_sm90.cu")
_DTYPES = (torch.float32, torch.bfloat16)
BN = 64                        # kBN in group_gemm.cu
BN_WGMMA = 128                 # kBN in group_gemm_sm90.cu
_INT_MAX = 2**31 - 1

launch_counts = {"group_gemm": 0}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_dir() -> pathlib.Path:
    # <repo>/src/repro_torch/kernels/moe_group_gemm/csrc -> <repo>/build
    return _CSRC.parents[4] / "build" / "moe_group_gemm"


def load_extension():
    """Compile (first call) and load the kernel's extension module."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)   # load() does not
            _ext = load(
                name="repro_torch_moe_group_gemm",
                sources=[str(_CSRC / s) for s in _SOURCES],
                build_directory=str(out),
                extra_cuda_cflags=["-O3", "-std=c++17",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                extra_cflags=["-O3"])
    return _ext


def tile_rows(c: int, dtype: torch.dtype) -> int:
    """Capacity rows per tile of the kernel for slabs of ``c`` rows."""
    if c <= 16:
        return 16
    return 256 if dtype == torch.bfloat16 else 64


def tile_cols(c: int, dtype: torch.dtype) -> int:
    """Output columns per tile of the kernel for slabs of ``c`` rows."""
    return BN_WGMMA if tile_rows(c, dtype) == 256 else BN


def tile_counts(counts: torch.Tensor, c: int, f: int,
                dtype: torch.dtype) -> tuple[int, int]:
    """(tiles, tiles skipped) that the tiling rule predicts for one launch
    over [E, c, *] slabs of ``dtype`` with ``f`` output columns: a tile is
    skipped when its first row is at or past its expert's count.  Reads
    ``counts`` back to the host; the kernel's own count is
    ``group_gemm_cuda(tiles=)``."""
    bm = tile_rows(c, dtype)
    per_expert = -(-c // bm)
    live = (counts.clamp(0, c) + bm - 1) // bm
    n_f = -(-f // tile_cols(c, dtype))
    total = counts.shape[0] * per_expert * n_f
    return total, total - int(live.sum()) * n_f


def _check(name: str, t: torch.Tensor, ndim: int, dtypes, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def group_gemm_cuda(xe: torch.Tensor, w: torch.Tensor,
                    counts: torch.Tensor, *,
                    tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel.  xe [E, C, D] float32 or bfloat16, w [E, D, F]
    in xe's dtype, counts [E] int32 on the card (values past C act as C,
    negative ones as 0).  Returns [E, C, F] float32 with the rows at or
    past counts[e] zero; the tiles past the count read nothing of xe or
    w.  ``tiles``, int32 [2] on the card, gets the launch's tiles and
    skipped tiles added to it by the kernel."""
    dev = xe.device
    _check("xe", xe, 3, _DTYPES, dev)
    _check("w", w, 3, (xe.dtype,), dev)
    _check("counts", counts, 1, (torch.int32,), dev)
    e, c, d = xe.shape
    if w.shape[:2] != (e, d):
        raise ValueError(f"xe {tuple(xe.shape)} and w {tuple(w.shape)} do "
                         "not chain expert by expert")
    if counts.shape[0] != e:
        raise ValueError(f"counts has {counts.shape[0]} entries for {e} "
                         "experts")
    f = w.shape[2]
    bm = tile_rows(c, xe.dtype)
    if e > 65535 or -(-c // bm) > 65535 or max(c, d, f) > _INT_MAX:
        raise ValueError(f"shape xe {tuple(xe.shape)} w {tuple(w.shape)} "
                         "is past the kernel's grid")
    item = xe.element_size()
    if d * item % 16 or f * item % 16:
        raise ValueError(f"rows of D {d} and F {f} must be whole 16 bytes "
                         f"({16 // item} {xe.dtype} elements)")
    if xe.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("xe and w must start on 16-byte boundaries")
    if tiles is None:
        tiles = torch.empty(0, dtype=torch.int32, device=dev)
    else:
        _check("tiles", tiles, 1, (torch.int32,), dev)
        if tiles.shape[0] != 2:
            raise ValueError(f"tiles must be [2], got {tuple(tiles.shape)}")
    out = torch.empty((e, c, f), dtype=torch.float32, device=dev)
    if out.numel():                  # nothing to write: nothing to launch
        load_extension().group_gemm(xe, w, counts, bm, out, tiles)
        launch_counts["group_gemm"] += 1
    return out
