"""Serving driver of the port: continuous batching through the decode
loop (see :mod:`repro_torch.serve.scheduler`), from
:mod:`repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 16 --max-new 64 --batch 8 --max-len 1024 [--paged]

Serves from dense per-slot KV stripes by default, as the JAX driver does;
``--paged`` serves from the paged pool.  Runs the full-width model on the
GPU by default; ``--reduced`` selects the smoke-scale config and
``--device cpu`` the plain PyTorch path.  Weights are random, from
``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models.init import cast_for_serving
from ..models.model_zoo import Model
from ..serve.engine import ServeConfig
from ..serve.scheduler import Batcher

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def run(arch: str | ArchConfig, *, reduced: bool = False, requests: int = 4,
        max_new: int = 8, batch: int = 4, max_len: int = 64, seed: int = 0,
        sync_every: int = 8, temperature: float = 0.0,
        eos_id: int | None = None, paged: bool = False, page_size: int = 16,
        total_pages: int | None = None, prompt_len: tuple[int, int] = (4, 12),
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda", params=None) -> dict:
    """Serve ``requests`` random prompts (lengths drawn from
    ``prompt_len`` = [lo, hi), tokens from ``seed``) from dense stripes,
    or from the paged pool with ``paged``, and print requests, tokens and
    tok/s.  ``arch`` is a registry name or a config (one cut in depth,
    say).  ``params`` (from the port's init or the bridge) replaces the
    seeded random weights when given; it is cast for serving in
    ``dtype``."""
    dev = resolve_device(device)
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = Model(cfg)
    if params is None:
        # built in the serving dtype: the full-width MoE tree fits the card
        # only so (the float32 leaves of cast_for_serving stay float32)
        params = model.init(seed, device=dev, dtype=dtype)
    params = cast_for_serving(params, dtype)
    scfg = ServeConfig(max_len=max_len, batch=batch, dtype=dtype,
                       sync_every=sync_every, temperature=temperature,
                       paged=paged, page_size=page_size,
                       total_pages=total_pages)
    b = Batcher(model, params, scfg, eos_id=eos_id, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = {}
    for rid in range(requests):
        n = int(rng.integers(prompt_len[0], prompt_len[1]))
        prompts[rid] = rng.integers(0, cfg.vocab, size=n).tolist()
        b.submit(rid, prompts[rid])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = b.run(max_new=max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in results.values())
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    layout = (f"paged pool {b.pool.n_pages}x{b.pool.page_size}" if paged
              else f"dense stripes {batch}x{max_len}")
    print(f"[serve] {len(results)} requests, {toks} tokens in {dt:.3f}s "
          f"({toks / dt:.1f} tok/s on {where}, {cfg.name}, {layout}, "
          f"{b.joins} joins, {b.segments} decode segments)")
    return {"results": results, "prompts": prompts, "tokens": toks,
            "seconds": dt, "tok_per_s": toks / dt, "joins": b.joins,
            "segments": b.segments}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool + per-slot page tables (default: "
                         "dense per-slot stripes)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--total-pages", type=int, default=None,
                    help="pool size in pages (default: batch * max pages)")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 12),
                    metavar=("LO", "HI"),
                    help="prompt lengths are drawn from [LO, HI)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    run(args.arch, reduced=args.reduced, requests=args.requests,
        max_new=args.max_new, batch=args.batch, max_len=args.max_len,
        seed=args.seed, sync_every=args.sync_every,
        temperature=args.temperature, eos_id=args.eos_id,
        paged=args.paged, page_size=args.page_size,
        total_pages=args.total_pages, prompt_len=tuple(args.prompt_len),
        dtype=_DTYPES[args.dtype], device=args.device)


if __name__ == "__main__":
    main()
