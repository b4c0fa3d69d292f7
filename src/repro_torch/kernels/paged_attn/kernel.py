"""Build, load and launch the hand-written CUDA paged-attention kernels.

Sources live in ``csrc/``: ``paged_decode.cu`` (replaces the TPU kernel
``repro/kernels/paged_attn/kernel.py::paged_attn_kernel``; the split-KV
walk of ``decode_split.cuh``, with ``splits`` from :mod:`.split`),
``paged_prefill.cu`` (replaces ``prefill_kernel.py::
paged_prefill_attn_kernel``; float32 on the CUDA cores, and the dispatch
by dtype), ``paged_prefill_tc.cu`` (the same kernel in bfloat16 on the
tensor cores) and ``binding.cpp``, the one file that includes PyTorch's
headers.  They are compiled for ``sm_90a`` with
``torch.utils.cpp_extension.load`` in one call, at the first launch, into
``build/paged_attn`` at the repository root.  Importing this module builds
nothing.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take; it allocates the output with
``torch.empty`` and launches on PyTorch's current stream.  It only ever
launches: the plain versions live in :mod:`.ref` and the routing between
the two, by the tensors' device, in :mod:`.ops`.  ``launch_counts`` counts
the launches of each kernel, so a run can show that its path went through
them; ``last_splits`` holds the cluster size of the last decode launch.
"""
from __future__ import annotations

import pathlib
import threading

import torch

from repro_torch.device import sm_count

from . import split

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "paged_decode.cu", "paged_prefill.cu",
            "paged_prefill_tc.cu")
_HEAD_DIMS = (16, 64, 128)     # reduced configs, qwen2-0.5b, moonshot
_DTYPES = (torch.float32, torch.bfloat16)
DECODE_MAX_GROUP = 16          # kMaxGroup in decode_split.cuh

launch_counts = {"paged_decode": 0, "paged_prefill": 0}
last_splits = {"paged_decode": None}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_dir() -> pathlib.Path:
    # <repo>/src/repro_torch/kernels/paged_attn/csrc -> <repo>/build
    return _CSRC.parents[4] / "build" / "paged_attn"


def load_extension():
    """Compile (first call) and load the kernels' extension module."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)   # load() does not
            _ext = load(
                name="repro_torch_paged_attn",
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


def _check_pages(q, k_pages, v_pages, table, dev) -> tuple[int, int]:
    _check("k_pages", k_pages, 4, (q.dtype,), dev)
    _check("v_pages", v_pages, 4, (q.dtype,), dev)
    _check("table", table, 2, (torch.int32,), dev)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "read rows in 16-byte chunks)")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape: "
                         f"{tuple(k_pages.shape)} vs {tuple(v_pages.shape)}")
    hq, d = q.shape[-2], q.shape[-1]
    hkv = k_pages.shape[2]
    if k_pages.shape[3] != d:
        raise ValueError(f"head_dim {d} of q != {k_pages.shape[3]} of pages")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    if table.shape[0] != q.shape[0]:
        raise ValueError(f"table rows {table.shape[0]} != batch {q.shape[0]}")
    return hq, hkv


def paged_attn_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the decode kernel.  q [B, Hq, D]; k_pages/v_pages [N, ps,
    Hkv, D] in q's dtype; table [B, P] int32 with every entry < N; lengths
    [B] int32.  One launch of ``split.split_count(B, Hkv, G, P x ps, SMs)``
    CTAs per (slot, KV head, row group).  Returns [B, Hq, D] in q's dtype."""
    dev = q.device
    _check("q", q, 3, _DTYPES, dev)
    hq, hkv = _check_pages(q, k_pages, v_pages, table, dev)
    _check("lengths", lengths, 1, (torch.int32,), dev)
    if lengths.shape[0] != q.shape[0]:
        raise ValueError("lengths must be [B]")
    if hq // hkv > DECODE_MAX_GROUP:
        raise ValueError(f"G = {hq // hkv} > {DECODE_MAX_GROUP} query heads "
                         "per KV head")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned (the kernel reads rows "
                         "in 16-byte chunks)")
    splits = split.split_count(q.shape[0], hkv, hq // hkv,
                               table.shape[1] * k_pages.shape[1],
                               sm_count(dev))
    ext = load_extension()
    out = torch.empty_like(q)
    ext.paged_decode(q, k_pages, v_pages, table, lengths, out, splits)
    launch_counts["paged_decode"] += 1
    last_splits["paged_decode"] = splits
    return out


def paged_prefill_attn_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, table: torch.Tensor,
                            q_offset: torch.Tensor,
                            kv_len: torch.Tensor) -> torch.Tensor:
    """Launch the prefill/verify kernel.  q [B, Lq, Hq, D] (the public
    layout; the kernel fuses token and group rows itself); k_pages/v_pages
    [N, ps, Hkv, D] in q's dtype; table [B, P] int32 with every entry < N;
    q_offset/kv_len [B] int32.  Returns [B, Lq, Hq, D] in q's dtype."""
    dev = q.device
    _check("q", q, 4, _DTYPES, dev)
    _check_pages(q, k_pages, v_pages, table, dev)
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        _check(name, t, 1, (torch.int32,), dev)
        if t.shape[0] != q.shape[0]:
            raise ValueError(f"{name} must be [B]")
    ext = load_extension()
    out = torch.empty_like(q)
    ext.paged_prefill(q, k_pages, v_pages, table, q_offset, kv_len, out)
    launch_counts["paged_prefill"] += 1
    return out
