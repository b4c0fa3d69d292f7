"""Build, load and launch the hand-written CUDA wavesim-volume kernel.

Sources live in ``csrc/``: ``volume.cu`` (replaces the TPU kernel
``repro/kernels/wavesim_volume/kernel.py::volume_kernel``) and
``binding.cpp``, the one file that includes PyTorch's headers.  They are
compiled for ``sm_90a`` with ``torch.utils.cpp_extension.load`` at the
first launch, into ``build/wavesim_volume`` at the repository root.
Importing this module builds nothing.

What bounds the kernel on an H100 is device-memory bytes: each row of 27
values is read once and written once.  The design (``volume.cu``'s
header): persistent CTAs, ``CTAS_PER_SM`` an SM (the grid sized here from
:func:`repro_torch.device.sm_count`), each walking tiles of
``TILE_ROWS`` rows over a ring of three stages in shared memory that TMA
bulk copies fill and empty, one thread a row.

The stencil.  The fused operator ``W`` is the sum of three Kronecker
products, so ``W[i, j]`` can be nonzero only where nodes i and j differ in
at most one of (i, j, k): 7 inputs for each output, 189 of the 729
entries (``STENCIL_NODES``; some are zero, such as the centre node's
diagonal, and stay in the list).  :func:`stencil_operator` takes those 189
values out of a ``W`` and raises on a ``W`` with anything off that
pattern; every ``W`` that :func:`fused_operator` builds passes.  The
kernel takes the stencil by value among its parameters (the GPU's
constant bank), the analogue of the TPU kernel's resident ``W`` block,
and sums each output's 7 terms in ascending node order in float32, which
for finite inputs equals the dense 27-term chain bit for bit apart from
the sign of a zero.  So the wrapper takes the stencil, never ``W``: a
caller gets it from :func:`stencil_operator` (the op from
:func:`.ops.operator`, once a (c, dtype)).  The wrapper checks device,
dtype, shape and contiguity and raises on anything the kernel does not
take, allocates the output with ``torch.empty`` and launches on
PyTorch's current stream.  The plain
version lives in :mod:`.ref` and the routing by the tensor's device in
:mod:`.ops`, which keeps the stencil of each (c, dtype).
``launch_counts`` counts launches.
"""
from __future__ import annotations

import pathlib
import threading

import numpy as np
import torch

from repro_torch.core.primitives.wavesim import NODES
from repro_torch.device import sm_count

from .. import launches

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("binding.cpp", "volume.cu")
_DTYPES = (torch.float32, torch.bfloat16)
TERMS = 7                           # inputs of an output (kTerms)
TILE_ROWS = 256                     # rows of a tile (kRows)
STAGES = 3                          # tiles of the ring (kStages)
CTAS_PER_SM = 2                     # the persistent grid (kCtasPerSm)


def _stencil_nodes() -> np.ndarray:
    """[27, 7]: for each output node j, the input nodes that differ from j
    in at most one of (i, j, k), ascending (``in_node`` in volume.cu)."""
    out = np.empty((NODES, TERMS), np.int64)
    for j in range(NODES):
        a, b, c = j // 9, j // 3 % 3, j % 3
        near = {i * 9 + b * 3 + c for i in range(3)}
        near |= {a * 9 + y * 3 + c for y in range(3)}
        near |= {a * 9 + b * 3 + z for z in range(3)}
        out[j] = sorted(near)
    return out


STENCIL_NODES = _stencil_nodes()
_PATTERN = np.zeros((NODES, NODES), bool)      # [input, output]
_PATTERN[STENCIL_NODES.ravel(), np.repeat(np.arange(NODES), TERMS)] = True

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


def stencil_operator(w: torch.Tensor) -> torch.Tensor:
    """The 189 values of a CPU ``W`` [27, 27] in the kernel's layout
    (row-vector @ W) on the stencil's pattern, as float32 [189]: entry
    ``j * 7 + t`` is ``W[STENCIL_NODES[j, t], j]``.  Raises ValueError if
    any entry off the pattern is nonzero (or NaN)."""
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"w must be a tensor, got {type(w).__name__}")
    if w.device.type != "cpu" or tuple(w.shape) != (NODES, NODES):
        raise ValueError(f"w must be a CPU [{NODES}, {NODES}] tensor, got "
                         f"{tuple(w.shape)} on {w.device}")
    wn = w.to(torch.float32).numpy()
    off = wn[~_PATTERN]
    if (off != 0).any():
        raise ValueError(f"w has {int((off != 0).sum())} nonzero entries "
                         f"off the 7-point stencil")
    vals = wn[STENCIL_NODES, np.arange(NODES)[:, None]]
    return torch.from_numpy(np.ascontiguousarray(vals.reshape(-1)))


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


def volume_cuda(x: torch.Tensor, stencil: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  x [R, 27] float32 or bfloat16 on the card (the
    element x field rows of u, read in place); ``stencil`` the float32
    [189] of :func:`stencil_operator` on the CPU.  Runs one CTA a tile of
    ``TILE_ROWS`` rows, at most ``CTAS_PER_SM`` for each SM of the card.
    Returns x @ W [R, 27], summed in float32, in x's dtype."""
    _check("x", x, _DTYPES, "cuda")
    if not isinstance(stencil, torch.Tensor):
        raise TypeError(f"stencil must be a tensor, got "
                        f"{type(stencil).__name__}")
    if (stencil.device.type != "cpu" or stencil.dim() != 1
            or stencil.numel() != NODES * TERMS
            or not stencil.is_contiguous()):
        raise ValueError(f"stencil must be {NODES * TERMS} contiguous values "
                         f"on the CPU, got {tuple(stencil.shape)} on "
                         f"{stencil.device}")
    if stencil.dtype != torch.float32:
        raise TypeError(f"stencil dtype {stencil.dtype} is not float32")
    out = torch.empty_like(x)
    if x.shape[0]:                   # no rows: nothing to launch
        tiles = -(-x.shape[0] // TILE_ROWS)
        grid = min(tiles, CTAS_PER_SM * sm_count(x.device))
        load_extension().volume(x, stencil, out, grid)
        launches.count(launch_counts, "wavesim_volume")
    return out
