"""Wave-simulation primitives (paper §2.3.1, §4.2.3), functional part.

From :mod:`repro.core.primitives.wavesim`: a simplified acoustic
Discontinuous Galerkin Method (DGM) step on a periodic 3-D structured mesh
of elements, p = 2 basis (27 nodes per element), ``n_fields`` coupled
fields.  ``volume`` applies the per-element reference derivative
operators; ``flux`` exchanges face values with the 6 neighbours and
applies an upwind penalty.  The op that runs the volume term on the card
is :func:`repro_torch.kernels.wavesim_volume.volume`; this module holds
the problem sizes and the plain versions of both terms and of the step.

The PIM-model half of the JAX module (``profile_*``, ``gpu_time_*``,
``pim_stream_*``, ``pim_time_*``, ``placement``, ``speedup_*``) needs the
timing simulator of ``repro.core`` and is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

ELEM_BYTES = 2
NODES_1D = 3                      # p = 2
NODES = NODES_1D ** 3             # 27 nodes / element
DEFAULT_FIELDS = 27               # 27 nodes x 27 values = 729 points/element


@dataclasses.dataclass(frozen=True)
class Problem:
    grid: tuple[int, int, int] = (40, 40, 40)   # ~65K elements (paper)
    n_fields: int = DEFAULT_FIELDS

    @property
    def n_elements(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def points_per_element(self) -> int:
        return NODES * self.n_fields           # 729 for the default

    @property
    def volume_bytes(self) -> int:
        # read u, write rhs; no inter-timestep reuse (§4.3.1)
        return 2 * self.n_elements * self.points_per_element * ELEM_BYTES

    @property
    def face_points(self) -> int:
        return NODES_1D ** 2 * self.n_fields   # one face's trace

    @property
    def flux_bytes(self) -> int:
        # read own + neighbor traces for 6 faces, accumulate rhs faces
        per_elem = (2 * 6 * self.face_points + 6 * self.face_points)
        return self.n_elements * per_elem * ELEM_BYTES


def reference_operator(dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """1-D nodal derivative matrix for the p=2 Legendre-Gauss-Lobatto basis
    on [-1, 1] (nodes -1, 0, 1)."""
    d = torch.tensor([[-1.5, 2.0, -0.5],
                      [-0.5, 0.0, 0.5],
                      [0.5, -2.0, 1.5]], dtype=torch.float64)
    return d.to(device=device, dtype=dtype)


def volume(u: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Volume term: rhs[e, f, i, j, k] = c * sum_d (D_d u)[e, f, i, j, k].

    u: [elements, fields, 3, 3, 3] nodal values.
    """
    d = reference_operator(u.dtype, u.device)
    du_i = torch.einsum("il,efljk->efijk", d, u)
    du_j = torch.einsum("jl,efilk->efijk", d, u)
    du_k = torch.einsum("kl,efijl->efijk", d, u)
    return c * (du_i + du_j + du_k)


def _shift(u: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """Neighbor element values along a grid axis (periodic boundary)."""
    return torch.roll(u, shifts=-direction, dims=axis)


def flux(u_grid: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """Face-flux term on the element grid.

    u_grid: [gx, gy, gz, fields, 3, 3, 3].  For each of the 6 faces, form
    the jump between the element's own face trace and the neighbor's
    opposing trace and accumulate the upwind penalty onto the face nodes.
    Each jump is added into ``rhs`` in place (JAX builds two zero arrays
    per axis for it); every node's sum keeps JAX's order, axis 0, then 1,
    then 2.
    """
    rhs = torch.zeros_like(u_grid)
    for axis in range(3):
        na = axis + 4                       # grid axis -> nodal axis
        own_hi = u_grid.select(na, 2)
        own_lo = u_grid.select(na, 0)
        nb_hi = _shift(u_grid, axis, +1).select(na, 0)
        nb_lo = _shift(u_grid, axis, -1).select(na, 2)
        rhs[_face_index(na, 2)] += alpha * (nb_hi - own_hi)
        rhs[_face_index(na, 0)] += alpha * (nb_lo - own_lo)
    return rhs


def _face_index(axis: int, idx: int):
    sl = [slice(None)] * 7
    sl[axis] = idx
    return tuple(sl)


def step(u_grid: torch.Tensor, dt: float = 1e-3, c: float = 1.0,
         alpha: float = 0.5) -> torch.Tensor:
    """One explicit-Euler DGM timestep (volume + flux)."""
    shape = u_grid.shape
    u_flat = u_grid.reshape((-1,) + tuple(shape[3:]))
    rhs_v = volume(u_flat, c).reshape(shape)
    rhs_f = flux(u_grid, alpha)
    return u_grid + dt * (rhs_v + rhs_f)
