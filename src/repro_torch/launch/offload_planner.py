"""PIM-offload planner over the assigned architectures (paper §3 made
executable), from ``examples/offload_planner.py``: which ops of each
(arch x shape) step are PIM-amenable, the estimated strawman-PIM speedup,
and the action the port takes instead on the H100.

  PYTHONPATH=src python -m repro_torch.launch.offload_planner --arch deepseek-v3-671b
"""
from __future__ import annotations

import argparse

from ..configs import ALL_ARCHS, get_config, shapes_for
from ..core.planner import render


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            print(render(cfg, shape))
            print()


if __name__ == "__main__":
    main()
