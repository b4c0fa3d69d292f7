"""Figure driver: one table per paper figure, from ``benchmarks/run.py``.

``PYTHONPATH=src python -m repro_torch.launch.figures.run [--fast]``

Prints ``name,us_per_call,derived`` CSV per table.  Paper-anchor rows embed
the paper's number and the model's delta.  Every table is the paper's
model, host arithmetic equal to the JAX package's; none touches a device.
A table that fails fails the run: nothing is skipped on an exception.
"""
from __future__ import annotations

import argparse

from . import (fig6_baseline_pim, fig8_wavesim_opt, fig9_ssgemm_sparsity,
               fig10_push_cacheaware, headline, limit_studies)
from .common import Table

LEFT_OUT = ("# not run here: the serving bench (the port's benchmark comes in "
            "a PR of its own), roofline_table (waits for sharding and the "
            "dry-run) and kernel_bench, which runs the kernels on the card: "
            "python -m repro_torch.launch.figures.kernel_bench")

# (title, module, slow): the slow tables run the LRU predictor over the
# three paper graphs; --fast leaves them out, as JAX's driver does
TABLES = (
    ("Fig 6 — baseline PIM speedup vs GPU", fig6_baseline_pim, False),
    ("Fig 8 — wavesim: arch-aware activation x registers", fig8_wavesim_opt,
     False),
    ("Fig 9 — ss-gemm: sparsity-aware PIM", fig9_ssgemm_sparsity, False),
    ("Fig 10 — push: cache-aware PIM + command bandwidth",
     fig10_push_cacheaware, True),
    ("Headline — average PIM speedup, baseline vs optimized", headline, True),
    ("Limit studies — registers x command bandwidth (§5.1.4)", limit_studies,
     True),
)


def run(fast: bool = False) -> dict[str, dict[str, float]]:
    """Emit every table (the slow three unless ``fast``) and return each
    module's ``run()`` dict under its module name."""
    out: dict[str, dict[str, float]] = {}
    for title, mod, slow in TABLES:
        if slow and fast:
            continue
        t = Table(title)
        out[mod.__name__.rsplit(".", 1)[-1]] = mod.run(t)
        t.emit()
    print(LEFT_OUT)
    return out


def main(argv: list[str] | None = None) -> dict[str, dict[str, float]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--fast", action="store_true",
                        help="skip the slower LRU-predictor tables")
    args = parser.parse_args(argv)
    return run(fast=args.fast)


if __name__ == "__main__":
    main()
