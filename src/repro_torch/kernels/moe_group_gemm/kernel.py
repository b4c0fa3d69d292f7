"""Build, load and launch the hand-written CUDA grouped expert GEMM and
its backward.

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
The backward's kernels (:func:`group_gemm_backward` in :mod:`.ops` runs
them): :func:`group_gemm_dy_cuda` masks float32 ``dy`` past each count
and casts it to the working dtype (``group_gemm.cu``);
:func:`group_gemm_dxe_cuda` computes ``dy @ w^T`` reading ``w`` as it lies
(bfloat16 past C 16 on the wgmma kernel of ``group_gemm_sm90.cu``, out in
bfloat16; float32 and C <= 16 on ``group_gemm.cu``'s tiles, out in
float32); :func:`group_gemm_dw_cuda` computes ``xe^T @ dy`` over each
expert's live rows only (bfloat16, ``group_gemm_sm90.cu``, persistent
CTAs; :func:`dw_tile_counts` predicts its tiles and K stages).
The plain versions live in :mod:`.ref` and the routing by the tensors'
device in :mod:`.ops`.  ``launch_counts`` counts launches (a launch
captured in a CUDA graph counts at each replay:
:mod:`repro_torch.kernels.launches`).
"""
from __future__ import annotations

import pathlib
import threading

import torch

from .. import launches

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "group_gemm.cu", "group_gemm_sm90.cu")
_DTYPES = (torch.float32, torch.bfloat16)
BN = 64                        # kBN in group_gemm.cu
BN_WGMMA = 128                 # kBN in group_gemm_sm90.cu
_INT_MAX = 2**31 - 1

BK = 64                        # kBK in group_gemm_sm90.cu: K rows a stage
BM_DW = 256                    # kBM in group_gemm_sm90.cu: rows of D a dw tile

launch_counts = {"group_gemm": 0, "group_gemm_dy": 0, "group_gemm_dxe": 0,
                 "group_gemm_dw": 0}

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


def on_wgmma(c: int, dtype: torch.dtype) -> bool:
    """Whether slabs of ``c`` rows of ``dtype`` take the wgmma kernels
    (bfloat16 past 16 rows, a join's or a training step's): the forward's
    and dxe's 256-row tiles, and the dw kernel."""
    return dtype == torch.bfloat16 and c > 16


def tile_rows(c: int, dtype: torch.dtype) -> int:
    """Capacity rows per tile of the kernel for slabs of ``c`` rows."""
    if c <= 16:
        return 16
    return 256 if on_wgmma(c, dtype) else 64


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


def dw_stages(counts: torch.Tensor, c: int) -> torch.Tensor:
    """[E] K stages of :data:`BK` rows that a dw tile of each expert runs:
    ceil(count / BK), counts clamped to [0, c]; 0 for an empty expert,
    whose tiles load nothing and write zeros."""
    return (counts.clamp(0, c) + BK - 1) // BK


def dw_tile_counts(counts: torch.Tensor, c: int, d: int,
                   f: int) -> tuple[int, int, int]:
    """(tiles, tiles of an empty expert, K stages run) that the dw
    kernel's launch over [E, c, d] x [E, c, f] runs: each expert has
    ceil(d / BM_DW) x ceil(f / BN_WGMMA) tiles, each running
    :func:`dw_stages` stages.  Reads ``counts`` back to the host; the
    kernel's own count is ``group_gemm_dw_cuda(tiles=)``."""
    per_expert = -(-d // BM_DW) * -(-f // BN_WGMMA)
    stages = dw_stages(counts, c)
    return (counts.shape[0] * per_expert,
            int((stages == 0).sum()) * per_expert,
            int(stages.sum()) * per_expert)


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


def _check_rows(dtype: torch.dtype, widths, *tensors: torch.Tensor) -> None:
    """Rows of ``widths`` elements of ``dtype`` whole 16 bytes, and the
    tensors on 16-byte aligned bases."""
    item = torch.empty((), dtype=dtype).element_size()
    for n in widths:
        if n * item % 16:
            raise ValueError(f"rows of {n} {dtype} elements are not whole "
                             "16 bytes")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("tensors must start on 16-byte boundaries")


def _check_tiles(tiles: torch.Tensor | None, n: int, dev) -> torch.Tensor:
    if tiles is None:
        return torch.empty(0, dtype=torch.int32, device=dev)
    _check("tiles", tiles, 1, (torch.int32,), dev)
    if tiles.shape[0] != n:
        raise ValueError(f"tiles must be [{n}], got {tuple(tiles.shape)}")
    return tiles


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
    _check_rows(xe.dtype, (d, f), xe, w)
    tiles = _check_tiles(tiles, 2, dev)
    out = torch.empty((e, c, f), dtype=torch.float32, device=dev)
    if out.numel():                  # nothing to write: nothing to launch
        load_extension().group_gemm(xe, w, counts, bm, out, tiles)
        launches.count(launch_counts, "group_gemm")
    return out


def group_gemm_dy_cuda(dy: torch.Tensor, counts: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The backward's first pass: dy [E, C, F] float32 on the card, counts
    [E] int32 -> [E, C, F] ``dtype`` (float32 or bfloat16) holding dy's
    rows below each count and zeros past it, whatever dy holds there (NaN
    included).  F must make whole 16-byte rows of ``dtype``."""
    dev = dy.device
    _check("dy", dy, 3, (torch.float32,), dev)
    _check("counts", counts, 1, (torch.int32,), dev)
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not in {_DTYPES}")
    if counts.shape[0] != dy.shape[0]:
        raise ValueError(f"counts has {counts.shape[0]} entries for "
                         f"{dy.shape[0]} experts")
    _check_rows(dtype, dy.shape[2:], dy)
    out = torch.empty(dy.shape, dtype=dtype, device=dev)
    if out.numel():
        load_extension().group_gemm_dy(dy, counts, out)
        launches.count(launch_counts, "group_gemm_dy")
    return out


def group_gemm_dxe_cuda(dy: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor, *,
                        tiles: torch.Tensor | None = None) -> torch.Tensor:
    """dxe[e] = dy[e] @ w[e]^T with w read as it lies: dy [E, C, F]
    (float32 or bfloat16, zero or not past each count), w [E, D, F] in
    dy's dtype, counts [E] int32 -> [E, C, D], rows at or past counts[e]
    exactly 0 (the tiles past the count read nothing).  bfloat16 with C >
    16 runs the wgmma kernel and returns bfloat16; the rest runs
    ``group_gemm.cu``'s tiles and returns float32.  ``tiles``, int32 [2],
    gets the launch's tiles and skipped tiles added, as
    :func:`tile_counts` (counts, C, D, dtype) predicts."""
    dev = dy.device
    _check("dy", dy, 3, _DTYPES, dev)
    _check("w", w, 3, (dy.dtype,), dev)
    _check("counts", counts, 1, (torch.int32,), dev)
    e, c, f = dy.shape
    if w.shape[0] != e or w.shape[2] != f:
        raise ValueError(f"dy {tuple(dy.shape)} and w {tuple(w.shape)} do "
                         "not chain expert by expert")
    if counts.shape[0] != e:
        raise ValueError(f"counts has {counts.shape[0]} entries for {e} "
                         "experts")
    d = w.shape[1]
    bm = tile_rows(c, dy.dtype)
    if e > 65535 or -(-c // bm) > 65535 or max(c, d, f) > _INT_MAX:
        raise ValueError(f"shape dy {tuple(dy.shape)} w {tuple(w.shape)} "
                         "is past the kernel's grid")
    _check_rows(dy.dtype, (f, d), dy, w)
    tiles = _check_tiles(tiles, 2, dev)
    out = torch.empty((e, c, d), device=dev, dtype=(
        torch.bfloat16 if bm == 256 else torch.float32))
    if out.numel():
        load_extension().group_gemm_dxe(dy, w, counts, bm, out, tiles)
        launches.count(launch_counts, "group_gemm_dxe")
    return out


def group_gemm_dw_cuda(xe: torch.Tensor, dy: torch.Tensor,
                       counts: torch.Tensor, *,
                       tiles: torch.Tensor | None = None) -> torch.Tensor:
    """dw[e] = xe[e]^T @ dy[e] over the rows below counts[e] alone: xe [E,
    C, D] and dy [E, C, F] bfloat16 (anything, NaN included, past each
    count), counts [E] int32, C >= 1 -> [E, D, F] bfloat16 (float32 sums);
    an empty expert's dw is 0 and reads nothing.  ``tiles``, int32 [3],
    gets the launch's tiles, tiles of an empty expert and K stages run
    added, as :func:`dw_tile_counts` predicts."""
    dev = xe.device
    _check("xe", xe, 3, (torch.bfloat16,), dev)
    _check("dy", dy, 3, (torch.bfloat16,), dev)
    _check("counts", counts, 1, (torch.int32,), dev)
    e, c, d = xe.shape
    if dy.shape[:2] != (e, c):
        raise ValueError(f"xe {tuple(xe.shape)} and dy {tuple(dy.shape)} "
                         "do not share experts and rows")
    if counts.shape[0] != e:
        raise ValueError(f"counts has {counts.shape[0]} entries for {e} "
                         "experts")
    f = dy.shape[2]
    if c < 1 or -(-d // BM_DW) * -(-f // BN_WGMMA) * e > _INT_MAX:
        raise ValueError(f"shape xe {tuple(xe.shape)} dy {tuple(dy.shape)}"
                         " is outside the kernel's range")
    _check_rows(torch.bfloat16, (d, f), xe, dy)
    tiles = _check_tiles(tiles, 3, dev)
    out = torch.empty((e, d, f), dtype=torch.bfloat16, device=dev)
    if out.numel():
        load_extension().group_gemm_dw(xe, dy, counts, out, tiles)
        launches.count(launch_counts, "group_gemm_dw")
    return out
