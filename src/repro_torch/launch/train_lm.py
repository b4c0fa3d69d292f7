"""End-to-end training driver example, from ``examples/train_lm.py``.

The default profile trains reduced qwen2-0.5b for 30 steps (seconds on
the CPU, and it demonstrably learns).  ``--profile 100m`` trains the
~100M-param qwen2-family config of :func:`hundred_m` for a few hundred
steps, through the same driver (``launch.train.run`` takes the config
itself).  Checkpoint/restart and failure injection are live in both.

  PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train_lm --profile 100m \\
      --steps 300
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from ..configs import get_config
from ..configs.base import ArchConfig
from .train import run


def hundred_m() -> ArchConfig:
    """~100M-param qwen2-family config (d=640, 12L, 32k vocab)."""
    base = get_config("qwen2-0.5b")
    return dataclasses.replace(
        base, name="qwen2-100m", n_layers=12, d_model=640, n_heads=10,
        kv_heads=2, d_ff=2560, vocab=32_000, head_dim=64)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", choices=("quick", "100m"), default="quick")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain path")
    args = ap.parse_args(argv)

    if args.profile == "quick":
        out = run("qwen2-0.5b", steps=args.steps or 30, batch=8, seq=128,
                  reduced=True, lr=3e-3, ckpt_dir=args.ckpt, ckpt_every=10,
                  fail_at=tuple(args.fail_at), device=args.device)
    else:
        out = run(hundred_m(), steps=args.steps or 300, batch=16, seq=512,
                  reduced=False, lr=3e-4, accum=2, ckpt_dir=args.ckpt,
                  ckpt_every=50, fail_at=tuple(args.fail_at),
                  device=args.device)
    print(f"final loss: {out['final_loss']:.4f} "
          f"(from {out['losses'][0]:.4f})")
    return out


if __name__ == "__main__":
    main()
