"""Wave-simulation demo: DGM timesteps through the port's kernels.

The counterpart of ``examples/wave_demo.py``: propagates a Gaussian
pressure pulse on a periodic mesh, with the volume term through the
wavesim-volume op (the CUDA kernel on the card, its plain version on the
CPU) and the functional flux, and prints the wavefront's motion.

    PYTHONPATH=src python -m repro_torch.launch.wave_demo [--paper] \
        [--steps N] [--dtype float32|bfloat16] [--device cpu]

The default is the demo's 8 x 8 x 8 grid with 3 fields, 40 steps at dt
5e-3; ``--paper`` runs at ``wavesim.Problem()`` (40^3 elements, 27
fields).  The device defaults to CUDA.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.core.primitives import wavesim
from repro_torch.device import resolve_device
from repro_torch.kernels.wavesim_volume import volume

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
DEMO_GRID, DEMO_FIELDS, DEMO_STEPS, DEMO_DT = (8, 8, 8), 3, 40, 5e-3


def initial_state(grid: tuple[int, int, int], fields: int, *,
                  device: str | torch.device = "cuda",
                  dtype: torch.dtype = torch.float32,
                  seed: int | None = None) -> torch.Tensor:
    """u [gx, gy, gz, fields, 3, 3, 3].  Without a seed: the demo's
    Gaussian pulse, exp(-r^2 / 4) on every node of field 0 around the
    grid's middle cell (the cell (4, 4, 4) on the demo's grid), zero
    elsewhere, rounded to float32 as the demo rounds it.  With a seed:
    standard-normal values drawn on the device from that seed."""
    dev = resolve_device(device)
    shape = tuple(grid) + (fields, 3, 3, 3)
    if seed is not None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    axes = [torch.arange(g, dtype=torch.float64) - g // 2 for g in grid]
    r2 = (axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
          + axes[2][None, None, :] ** 2)
    u = torch.zeros(shape, dtype=torch.float32)
    u[:, :, :, 0] = torch.exp(-r2 / 4.0).to(torch.float32)[..., None, None,
                                                            None]
    return u.to(device=dev, dtype=dtype)


def energy_line(step: int, u: torch.Tensor) -> str:
    """The demo's line: the energy (each element's sum of squares) at the
    middle cell, at the cell three cells before it along axis 0, and in
    total."""
    e = torch.square(u.float()).sum(dim=(3, 4, 5, 6)).cpu().numpy()
    c0, c1, c2 = (g // 2 for g in e.shape)
    return (f"step {step:3d}: energy center={e[c0, c1, c2]:8.4f} "
            f"shell={e[max(c0 - 3, 0), c1, c2]:8.4f} total={e.sum():9.3f}")


def run(grid: tuple[int, int, int] = DEMO_GRID, fields: int = DEMO_FIELDS,
        steps: int = DEMO_STEPS, dt: float = DEMO_DT, *,
        device: str | torch.device = "cuda",
        dtype: torch.dtype = torch.float32, seed: int | None = None,
        verbose: bool = True) -> dict:
    """``steps`` explicit-Euler steps, ``u + dt * (rhs_v + rhs_f)``, as
    ``examples/wave_demo.py`` takes them: ``rhs_v`` from the volume op,
    ``rhs_f`` from ``wavesim.flux``.  Every tenth step prints its energy
    line.  Returns the final ``u``, the energy lines, and the time of each
    step and of its volume term, with their means (CUDA events on the card,
    the host clock on the CPU; the energy lines are outside the timed
    spans)."""
    dev = resolve_device(device)
    u = initial_state(grid, fields, device=dev, dtype=dtype, seed=seed)
    shape = u.shape
    cuda = dev.type == "cuda"
    marks = []                        # (start, after volume, end) per step
    lines = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    for step in range(steps):
        t0 = mark()
        flat = u.reshape((-1, fields, 3, 3, 3))
        rhs_v = volume(flat).reshape(shape)
        t1 = mark()
        rhs_f = wavesim.flux(u)
        u = u + dt * (rhs_v + rhs_f)
        marks.append((t0, t1, mark()))
        if step % 10 == 0:
            lines.append(energy_line(step, u))
            if verbose:
                print(lines[-1])
    if cuda:
        torch.cuda.synchronize(dev)
        step_ms = [a.elapsed_time(c) for a, _, c in marks]
        vol_ms = [a.elapsed_time(b) for a, b, _ in marks]
    else:
        step_ms = [1e3 * (c - a) for a, _, c in marks]
        vol_ms = [1e3 * (b - a) for a, b, _ in marks]
    if verbose and seed is None:
        print("pulse propagates outward (center decays, shell rises)")
    return {"u": u, "energy": lines, "device": str(dev),
            "step_ms": step_ms, "volume_ms": vol_ms,
            "ms_per_step": sum(step_ms) / max(steps, 1),
            "volume_ms_per_step": sum(vol_ms) / max(steps, 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paper", action="store_true",
                    help="wavesim.Problem(): 40^3 elements, 27 fields")
    ap.add_argument("--steps", type=int, default=DEMO_STEPS)
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain path)")
    args = ap.parse_args()
    grid, fields = DEMO_GRID, DEMO_FIELDS
    if args.paper:
        prob = wavesim.Problem()
        grid, fields = prob.grid, prob.n_fields
    res = run(grid, fields, args.steps, device=args.device,
              dtype=_DTYPES[args.dtype])
    # the median: the first step also loads the kernel's extension
    print(f"[wave] grid {'x'.join(map(str, grid))}, {fields} fields, "
          f"{args.steps} steps, {args.dtype} on {res['device']}: "
          f"{statistics.median(res['step_ms']):.3f} ms/step, volume "
          f"{statistics.median(res['volume_ms']):.3f} ms/step (medians)")


if __name__ == "__main__":
    main()
