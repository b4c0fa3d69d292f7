"""Device meshes, from :mod:`repro.launch.mesh`, and the process groups
they need.

Functions, not module constants, so importing touches no device or
process-group state.  Single-pod: 16 x 16 = 256 ranks (data, model).
Multi-pod: 2 x 16 x 16 = 512 ranks (pod, data, model); the pod axis is
the slowest dimension and carries only data parallelism.  A torch mesh
needs an initialised process group of at least its size: on hardware one
process a card; for the dry-run, :func:`fake_world`, torch's fake
backend, where every rank is rank 0 and no collective moves data.
:func:`local_world` is a one-process group for one card or the CPU.
"""
from __future__ import annotations

import contextlib
import math
import tempfile

import torch
import torch.distributed as dist


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under NCCL, else ``cpu`` (gloo
    and the fake backend)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, have {have}: run under "
            "repro_torch.launch.mesh.fake_world (the dry-run) or on "
            "real hardware with one process a card")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_host_mesh():
    """Whatever-fits mesh for local runs: the process group's n ranks as
    (n / model, model), model the largest of 4, 2, 1 dividing n (one
    card: (1, 1))."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return _mesh((max(1, n // model), model), ("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` fake ranks for this process
    (rank 0), torn down on exit.  Collectives return at once and move
    nothing; pair it with ``FakeTensorMode`` or ``meta`` tensors so that
    nothing is allocated either."""
    # the fake backend registers itself when this private module loads
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def local_world(backend: str = "gloo", *, rank: int = 0,
                world_size: int = 1, store_dir: str | None = None):
    """A real process group (``gloo`` on the CPU, ``nccl`` on cards)
    through a ``FileStore`` in ``store_dir`` (a fresh temp dir when
    None: one process), torn down on exit."""
    with contextlib.ExitStack() as stack:
        if store_dir is None:
            store_dir = stack.enter_context(tempfile.TemporaryDirectory())
        store = dist.FileStore(f"{store_dir}/store", world_size)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
        try:
            yield
        finally:
            dist.destroy_process_group()
