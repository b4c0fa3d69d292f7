"""Build, load and launch the hand-written CUDA skinny-GEMM kernels.

Sources live in ``csrc/``: two kernel bodies that each take both k-block
walks of ``walk.cuh`` (together they replace the TPU kernels
``repro/kernels/ss_gemm/kernel.py::ssgemm_masked_kernel`` and
``ssgemm_compact_kernel``): ``ss_gemm_tc.cu``, bfloat16 products on the
tensor cores (``mma.sync``) fed by a ``cp.async`` ring, a CTA per 64 rows
of M; and ``ss_gemm.cu``, products on the CUDA cores in float32, a warp
per 4 or 8 rows.  ``binding.cpp`` is the one file that includes PyTorch's
headers.  They are compiled for ``sm_90a`` with
``torch.utils.cpp_extension.load`` at the first launch, into
``build/ss_gemm`` at the repository root.  Importing this module builds
nothing.

:func:`route` chooses the kernel body before each launch, by the operands'
dtype, shape and alignment; each route is its own binding entry point, and
a launch that fails on either raises.  The wrappers check device, dtype,
shape and contiguity and raise on anything the kernels do not take; they
allocate the output with ``torch.empty`` and launch on PyTorch's current
stream.  ``bk`` is the skip granularity.  The plain versions live in
:mod:`.ref` and the routing by the tensors' device in :mod:`.ops`.
``launch_counts`` counts launches by walk, ``route_counts`` by route.
"""
from __future__ import annotations

import pathlib
import threading

import torch

from .. import launches

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "ss_gemm.cu", "ss_gemm_tc.cu")
_DTYPES = (torch.float32, torch.bfloat16)
MAX_WIDTH = 16                 # kMaxWidth in both .cu files
_INT_MAX = 2**31 - 1

launch_counts = {"ssgemm_masked": 0, "ssgemm_compact": 0}
route_counts = {"tensor_core": 0, "cuda_core": 0}

_ext = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts):
        for name in counts:
            counts[name] = 0


def route(a: torch.Tensor, b: torch.Tensor, bk: int) -> str:
    """The kernel body a launch on a [M, K] and b [K, N] with k-blocks of
    ``bk`` takes: ``"tensor_core"`` (``ss_gemm_tc.cu``) for bfloat16 whose
    rows of A are whole 16 bytes (K % 8 == 0), with A and B on 16-byte
    aligned addresses and bk % 16 == 0; ``"cuda_core"`` (``ss_gemm.cu``)
    for everything else: float32, a ragged K, unaligned views."""
    if (a.dtype == torch.bfloat16 and a.shape[1] % 8 == 0 and bk % 16 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0):
        return "tensor_core"
    return "cuda_core"


def build_dir() -> pathlib.Path:
    # <repo>/src/repro_torch/kernels/ss_gemm/csrc -> <repo>/build
    return _CSRC.parents[4] / "build" / "ss_gemm"


def load_extension():
    """Compile (first call) and load the kernels' extension module."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)   # load() does not
            _ext = load(
                name="repro_torch_ss_gemm",
                sources=[str(_CSRC / s) for s in _SOURCES],
                build_directory=str(out),
                extra_cuda_cflags=["-O3", "-std=c++17",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                extra_cflags=["-O3"])
    return _ext


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


def _check_operands(a: torch.Tensor, b: torch.Tensor, bk: int) -> int:
    """Validates a [M, K], b [K, N] and bk; returns the block count."""
    dev = a.device
    _check("a", a, 2, _DTYPES, dev)
    _check("b", b, 2, (a.dtype,), dev)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         "chain")
    if not 1 <= b.shape[1] <= MAX_WIDTH:
        raise ValueError(f"N = {b.shape[1]}: the kernels take skinny B of "
                         f"1 to {MAX_WIDTH} columns")
    if k < 1 or m > _INT_MAX or k > _INT_MAX:
        raise ValueError(f"K must be in [1, 2**31), M below 2**31; got "
                         f"{tuple(a.shape)}")
    if not isinstance(bk, int) or not 1 <= bk <= k:
        raise ValueError(f"bk must be an int in [1, K={k}], got {bk!r}")
    return -(-k // bk)


def ssgemm_masked_cuda(a: torch.Tensor, b: torch.Tensor,
                       block_mask: torch.Tensor, bk: int) -> torch.Tensor:
    """Launch the mask walk.  a [M, K] float32 or bfloat16, b [K, N] in
    a's dtype (N <= 16), block_mask [ceil(K / bk)] int32; the k-blocks
    whose entry is 0 are skipped and nothing of them is loaded.  Returns
    [M, N] float32."""
    nk = _check_operands(a, b, bk)
    _check("block_mask", block_mask, 1, (torch.int32,), a.device)
    if block_mask.shape[0] != nk:
        raise ValueError(f"block_mask has {block_mask.shape[0]} entries, "
                         f"K={a.shape[1]} in blocks of {bk} needs {nk}")
    out = torch.empty(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    if a.shape[0]:                   # no rows: nothing to launch
        path = route(a, b, bk)
        ext = load_extension()
        launch = (ext.ssgemm_masked_tc if path == "tensor_core"
                  else ext.ssgemm_masked)
        launch(a, b, block_mask, bk, out)
        launches.count(launch_counts, "ssgemm_masked")
        launches.count(route_counts, path)
    return out


def ssgemm_compact_cuda(a: torch.Tensor, b: torch.Tensor,
                        block_idx: torch.Tensor, n_live: torch.Tensor,
                        bk: int) -> torch.Tensor:
    """Launch the list walk.  block_idx [budget] int32 k-block ids,
    n_live [1] int32 on the card: the kernel sums the blocks
    ``block_idx[j]`` for ``j < min(n_live, budget)``, reading n_live
    itself (no host read).  Returns [M, N] float32."""
    _check_operands(a, b, bk)
    _check("block_idx", block_idx, 1, (torch.int32,), a.device)
    _check("n_live", n_live, 1, (torch.int32,), a.device)
    if block_idx.shape[0] < 1 or n_live.shape[0] != 1:
        raise ValueError(f"block_idx needs >= 1 entry and n_live exactly 1; "
                         f"got {tuple(block_idx.shape)}, "
                         f"{tuple(n_live.shape)}")
    out = torch.empty(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    if a.shape[0]:                   # no rows: nothing to launch
        path = route(a, b, bk)
        ext = load_extension()
        launch = (ext.ssgemm_compact_tc if path == "tensor_core"
                  else ext.ssgemm_compact)
        launch(a, b, block_idx, n_live, bk, out)
        launches.count(launch_counts, "ssgemm_compact")
        launches.count(route_counts, path)
    return out
