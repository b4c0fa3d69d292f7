"""Wave-simulation primitives (paper §2.3.1, §4.2.3), functional part.

From :mod:`repro.core.primitives.wavesim`: a simplified acoustic
Discontinuous Galerkin Method (DGM) step on a periodic 3-D structured mesh
of elements, p = 2 basis (27 nodes per element), ``n_fields`` coupled
fields.  ``volume`` applies the per-element reference derivative
operators; ``flux`` exchanges face values with the 6 neighbours and
applies an upwind penalty.  The op that runs the volume term on the card
is :func:`repro_torch.kernels.wavesim_volume.volume`; this module holds
the problem sizes, the plain versions of both terms and of the step, and
the paper's model of both terms.

PIM model
---------
Command streams follow the §4.2.3 orchestration: elements distributed
lane-and-bank parallel (aligned data parallelism over the regular grid),
reference-operator entries broadcast as immediates, pim-registers staging
rows.  Schedules are register-pressure-shaped (§4.2.3 "considerable care is
necessary to effectively utilize available registers"):

* *volume* visits 3 rows per chunk (field row in, operator-mix row,
  rhs row out) with a compute-rich middle phase;
* *flux* visits 6 rows per chunk (own faces, three neighbor-face rows,
  normals/penalty row, flux output row) with few commands per visit —
  which is why its activation overhead is ~2x volume's and why
  architecture-aware activation only pays off once registers grow
  (paper Fig. 8).

Face interactions that cross banks (GridPlacement.cross_bank_frac) cannot
execute in PIM (§3.2) and are charged to the GPU serially.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import gpu_model
from ..amenability import Interaction, PrimitiveProfile
from ..commands import Node
from ..hwspec import GpuSpec, PimSpec
from ..optimizations import Phase, chunk_cols, schedule
from ..placement import GridPlacement, grid_placement
from ..timing import TimingStats, simulate

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


# ------------------------- amenability ------------------------------------

def profile_volume(problem: Problem) -> PrimitiveProfile:
    # op count follows the hand-scheduled PIM stream (useful MACs per byte
    # staged), landing in the paper's stated 0.43-1.72 op/byte range —
    # DGM implementations fold operator symmetries, so the naive
    # 3 x 27 x 27 contraction overcounts.
    ops = problem.volume_bytes * 1.1
    return PrimitiveProfile(
        name="wavesim-volume", ops=float(ops),
        mem_bytes=float(problem.volume_bytes), onchip_bytes=1.0,
        interaction=Interaction.LOCALIZED, alignable=True,
        notes="regular grid; operators broadcast as immediates",
    )


def profile_flux(problem: Problem) -> PrimitiveProfile:
    ops = problem.flux_bytes * 0.5   # jump+penalty per face word (see above)
    return PrimitiveProfile(
        name="wavesim-flux", ops=float(ops),
        mem_bytes=float(problem.flux_bytes), onchip_bytes=1.0,
        interaction=Interaction.LOCALIZED, alignable=True,
        input_dependent_locality=False,
        notes="neighbor faces need same-bank placement; residual cross-bank "
              "faces stay on the GPU",
    )


# ------------------------- GPU baseline -----------------------------------

def gpu_time_volume_ns(problem: Problem, gpu: GpuSpec) -> float:
    return gpu_model.time_ns(problem.volume_bytes, gpu)


def gpu_time_flux_ns(problem: Problem, gpu: GpuSpec) -> float:
    return gpu_model.time_ns(problem.flux_bytes, gpu)


# ------------------------- PIM streams ------------------------------------
# Schedule shapes (see module docstring).  Command counts per chunk are
# expressed per 32 B word of data staged, with the compute phase's richness
# set by the primitive's op/byte (hand-scheduled, §4.2.3).

VOLUME_PHASE_SHAPE = (1.5, 1.75, 1.0)   # (ld u, operator MACs, st rhs) x cols
VOLUME_WORD_DIV = 2.0                   # staged words per accounting word
FLUX_PHASE_SHAPE = (0.75, 0.5, 0.5, 0.5, 0.56, 0.75)
# flux: own-face ld, 3 neighbor-face visits, normals/penalty, st flux
FLUX_WORD_DIV = 2.16
# Register spills (§4.3.3): below 32 registers the flux working set (own +
# neighbor traces + penalties + intermediates) does not fit, forcing two
# extra scratch-row visits per chunk — the "high intermediate results which
# also consume registers" effect that keeps arch-aware activation from
# paying off until registers grow (Fig. 8).
FLUX_SPILL_SHAPE = (0.25, 0.25)
FLUX_SPILL_REG_THRESHOLD = 32


def _stream(problem_words: int, shape: tuple[float, ...], pim: PimSpec,
            arch_aware: bool, regs: int,
            n_serial: int = 0) -> list[Node]:
    cols = chunk_cols(regs)
    phases = [Phase(max(1, round(s * cols)), serial=(i >= len(shape) - n_serial))
              for i, s in enumerate(shape)]
    words_per_bank = problem_words / (pim.banks_per_stack)
    trips = max(1, round(words_per_bank / cols))
    return schedule(phases, trips, arch_aware)


def _volume_words(problem: Problem, pim: PimSpec) -> int:
    return int(problem.volume_bytes / pim.dram_word_bytes / VOLUME_WORD_DIV)


def pim_stream_volume(problem: Problem, pim: PimSpec, *,
                      arch_aware: bool = False,
                      regs: int | None = None) -> list[Node]:
    regs = regs or pim.pim_regs_per_alu
    return _stream(_volume_words(problem, pim), VOLUME_PHASE_SHAPE, pim,
                   arch_aware, regs)


def pim_stream_flux(problem: Problem, pim: PimSpec, *,
                    arch_aware: bool = False,
                    regs: int | None = None) -> list[Node]:
    regs = regs or pim.pim_regs_per_alu
    words = int(problem.flux_bytes / pim.dram_word_bytes / FLUX_WORD_DIV)
    shape = FLUX_PHASE_SHAPE
    n_serial = 0
    if regs < FLUX_SPILL_REG_THRESHOLD:
        shape = shape + FLUX_SPILL_SHAPE
        n_serial = len(FLUX_SPILL_SHAPE)
    return _stream(words, shape, pim, arch_aware, regs, n_serial=n_serial)


def pim_time_volume(problem: Problem, pim: PimSpec, *,
                    arch_aware: bool = False,
                    regs: int | None = None) -> TimingStats:
    return simulate(pim_stream_volume(problem, pim, arch_aware=arch_aware,
                                      regs=regs), pim)


def pim_time_flux(problem: Problem, pim: PimSpec, *,
                  arch_aware: bool = False,
                  regs: int | None = None) -> TimingStats:
    return simulate(pim_stream_flux(problem, pim, arch_aware=arch_aware,
                                    regs=regs), pim)


def placement(problem: Problem, pim: PimSpec) -> GridPlacement:
    return grid_placement(problem.grid, pim)


def speedup_volume(problem: Problem, pim: PimSpec, gpu: GpuSpec, *,
                   arch_aware: bool = False, regs: int | None = None) -> float:
    return gpu_time_volume_ns(problem, gpu) / pim_time_volume(
        problem, pim, arch_aware=arch_aware, regs=regs).time_ns


def speedup_flux(problem: Problem, pim: PimSpec, gpu: GpuSpec, *,
                 arch_aware: bool = False, regs: int | None = None) -> float:
    """Flux speedup including cross-bank ghost faces.

    Faces crossing a bank boundary (GridPlacement.cross_bank_frac of face
    interactions) cannot interact inside PIM (§3.2); the host refreshes
    ghost copies of those neighbor traces concurrently with PIM execution
    (traffic: chi of the neighbor-trace third of flux bytes), so the slower
    of the two dominates.
    """
    pim_t = pim_time_flux(problem, pim, arch_aware=arch_aware,
                          regs=regs).time_ns
    chi = placement(problem, pim).cross_bank_frac
    ghost_t = gpu_model.time_ns(chi * problem.flux_bytes / 3.0, gpu)
    gpu_t = gpu_time_flux_ns(problem, gpu)
    return gpu_t / (max(pim_t, ghost_t) + 0.1 * min(pim_t, ghost_t))
