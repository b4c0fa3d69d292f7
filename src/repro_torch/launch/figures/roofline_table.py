"""Roofline table: three terms per (arch x shape) from the port's dry-run
records, from ``benchmarks/roofline_table.py``.

Reads ``artifacts/dryrun_torch/*__single.json`` (the 16 x 16 mesh).
Columns: compute/memory/collective terms (ms) on the H100 spec
(:class:`repro_torch.core.hwspec.HopperSpec`; spec-sheet bounds on host
arithmetic, not measurements), the dominant bound, the MODEL_FLOPS /
trace FLOPs usefulness ratio and the roofline fraction (useful-compute
time / dominant term); then the multi-pod scaling of each cell that has
both meshes.

  PYTHONPATH=src python -m repro_torch.launch.figures.roofline_table
"""
from __future__ import annotations

import pathlib

from ...core.hwspec import DEFAULT_HOPPER
from ...roofline.analysis import from_artifact
from ..dryrun import ARTIFACTS


def rows(mesh: str = "single", root: pathlib.Path = ARTIFACTS):
    return [from_artifact(path)
            for path in sorted(root.glob(f"*__{mesh}.json"))]


def main(root: pathlib.Path = ARTIFACTS) -> list:
    """Print the tables; return the single-mesh rows.  Raises when
    ``root`` holds no record."""
    rl = rows(root=root)
    if not rl:
        raise FileNotFoundError(
            f"no dry-run records in {root}; run PYTHONPATH=src python -m "
            "repro_torch.launch.dryrun --all")
    h = DEFAULT_HOPPER
    print(f"# Roofline: per (arch x shape), single-pod 16x16 (H100 spec: "
          f"{h.peak_bf16_tflops:g} TF/s bf16, {h.hbm_gbps / 1e3:g} TB/s "
          f"HBM, {h.nvlink_gbps:g} GB/s NVLink, a lower bound)")
    print("arch,shape,mesh,compute_ms,memory_ms,collective_ms,bound,"
          "useful_ratio,roofline_frac")
    for r in sorted(rl, key=lambda r: (r.arch, r.shape)):
        print(r.row())
    print()

    # multi-pod scaling: per-device terms at 512 ranks vs 256 (the pod
    # axis carries data parallelism only)
    single = {(r.arch, r.shape): r for r in rl}
    print("# Multi-pod scaling: 2x16x16 vs 16x16, per-device terms")
    print("arch,shape,compute_ratio,collective_ratio,note")
    for m in rows("multi", root):
        s = single.get((m.arch, m.shape))
        if s is None or not s.compute_ns:
            continue
        cr = m.compute_ns / s.compute_ns
        xr = (m.collective_ns / s.collective_ns
              if s.collective_ns else float("nan"))
        note = ("data-parallel weak scaling" if cr < 0.7
                else "batch-bound (replicated work)")
        print(f"{m.arch},{m.shape},{cr:.2f},{xr:.2f},{note}")
    print()
    return rl


if __name__ == "__main__":
    main()
