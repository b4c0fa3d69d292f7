"""Sweep the paged-attention kernels' launch knobs on the card and persist
the winners to the port's tuned-launch cache, from ``scripts/autotune.py``.

Per (op, geometry) this enumerates every launch the kernels accept
(decode: ``ctas_per_sm`` x ``cta_rows``; prefill and verify:
``block_rows``), prunes with :func:`~repro_torch.kernels.paged_attn.
autotune.feasible` and the analytic score (a refused candidate never
runs), times the survivors' device time a call from one CUDA graph each,
parity-gates every candidate against the default launch (bf16 2e-2,
float32 1e-4), and merges the winner into
``src/repro_torch/kernels/paged_attn/tuned_shapes.json`` keyed
``<device type>|<op>|<geometry>``, with the card's name and power limit.
The policy (:class:`~repro_torch.kernels.decode_attn.ops.
DecodeAttnPolicy`) loads that file, so serving uses the winners.  Page
size is a geometry axis (it changes the pool layout): ``--page-sizes``
sweeps it as separate entries.

The workloads are the serve cells' shapes (``PERF.md`` section 4): decode
at batch 8 over depths 64-600, the verify at 8 slots, Lq 5, depths
320-600, and a join of 8 prompts of 64-512 tokens (Lq 512).

  PYTHONPATH=src python -m repro_torch.launch.autotune --arch qwen2-0.5b
  python -m repro_torch.launch.autotune --arch moonshot-v1-16b-a3b --smoke
  python -m repro_torch.launch.autotune --dry-run --device cpu   # prune only
  python -m repro_torch.launch.autotune --no-save --out /tmp/t.json

``--smoke`` bounds the sweep: the first page size only, at most 8
measured candidates per op, 2 timing reps.  ``--device cpu`` runs the
harness on the plain route, where the knobs change nothing.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config
from ..device import resolve_device
from ..kernels.paged_attn import autotune as at

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def serve_shapes(b: int = 8, lq: int | None = None,
                 pages: int | None = None) -> dict:
    """Each op's workload keywords at the serve cells' shapes; ``b``,
    ``lq`` (verify and prefill) and ``pages`` override them."""
    shapes = {"decode": dict(b=b, lq=1, depths=(64, 600)),
              "verify": dict(b=b, lq=lq or 5, depths=(320, 600)),
              "prefill": dict(b=b, lq=lq or 512, depths=(64, 512))}
    for kw in shapes.values():
        kw["pages"] = pages
    return shapes


def geometry(arch: str, page_size: int) -> at.Geometry:
    cfg = get_config(arch)
    if cfg.attn.value == "none":
        raise ValueError(f"{arch} is attention-free: no paged-attention "
                         "launch to tune")
    return at.Geometry(hq=cfg.n_heads, hkv=cfg.kv_heads,
                       d=cfg.resolved_head_dim, page_size=page_size)


def sweep(arch: str, *, ops=at.OPS, page_sizes=(16,), b: int = 8,
          lq: int | None = None, pages: int | None = None,
          budget: int | None = None, reps: int = 3, seed: int = 0,
          device: str | torch.device = "cuda",
          dtype: torch.dtype = torch.bfloat16, out: str | None = None,
          save: bool = True, dry_run: bool = False) -> dict:
    """Sweep ``ops`` at each page size of ``arch``'s full-width geometry;
    print one line a candidate and one a winner, and merge the winners
    into ``out`` (default: the committed cache) unless ``save`` is False.
    Returns ``{geometry key: autotune results}`` (empty for a dry run)."""
    dev = resolve_device(device)
    shapes = serve_shapes(b, lq, pages)
    print(f"[autotune] arch={arch} device={dev} ops={','.join(ops)} "
          f"page_sizes={list(page_sizes)} budget={budget} reps={reps} "
          f"dtype={str(dtype).split('.')[1]}")
    done = {}
    for ps in page_sizes:
        geom = geometry(arch, ps)
        if dry_run:
            for op in ops:
                wl = at.make_workload(op, geom, seed=seed, device=dev,
                                      dtype=dtype, **shapes[op])
                cands, pruned = at.prune(wl, budget=budget)
                print(f"  {geom.key()} {op}: would run "
                      f"{[c.label(op) for c in cands]}; pruned "
                      f"{[(c.label(op), why) for c, why in pruned]}")
            continue
        res = at.autotune(ops, geom=geom, shapes=shapes, budget=budget,
                          reps=reps, seed=seed, device=dev, dtype=dtype)
        for op, r in res.items():
            for row in r["candidates"]:
                label = at.Candidate(**row["config"]).label(op)
                print(f"  {geom.key()} {op:<7} {label:<14} "
                      f"{row['ms']:.5f} ms ({row['timer']}), "
                      f"{row['achieved_gbps']:.1f} GB/s, max_abs_diff "
                      f"{row['max_abs_diff']:.3e}, bit-exact "
                      f"{row['bit_exact']}")
            for row in r["parity_dropped"]:
                print(f"  {geom.key()} {op:<7} dropped {row['config']}: "
                      f"{row['reason']}")
            win = at.Candidate(**r["winner"]).label(op)
            print(f"[autotune] {geom.key()} {op:<7} winner {win:<14} "
                  f"{r['winner_ms']:.5f} ms (default "
                  f"{r['default_ms']:.5f} ms), "
                  f"{r['achieved_gbps']:.1f} GB/s, op/byte "
                  f"{r['op_byte']:.2f} [{len(r['candidates'])} measured, "
                  f"{len(r['pruned'])} pruned, "
                  f"{len(r['parity_dropped'])} parity-dropped]; "
                  f"{r['workload']}; {r['card']}")
        if save:
            path = at.save_entries(res, out)
            print(f"[autotune] winners merged into {path}")
        done[geom.key()] = res
    return done


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--ops", default=",".join(at.OPS),
                    help="comma-separated subset of decode,prefill,verify")
    ap.add_argument("--page-sizes", default="16",
                    help="pool page sizes to sweep (each is its own "
                         "geometry entry)")
    ap.add_argument("--b", type=int, default=8, help="workload slots")
    ap.add_argument("--lq", type=int, default=None,
                    help="query tokens of the verify and the prefill "
                         "(default 5 and 512)")
    ap.add_argument("--pages", type=int, default=None,
                    help="pool pages in the workload (default: enough for "
                         "the deepest slot)")
    ap.add_argument("--budget", type=int, default=None,
                    help="max measured candidates per op (analytic rank "
                         "cuts the rest; default: all feasible)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed replays per surviving candidate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain route: checks "
                         "the harness, tunes nothing)")
    ap.add_argument("--out", default=None,
                    help="cache file to merge winners into (default: the "
                         "committed tuned_shapes.json of the port)")
    ap.add_argument("--smoke", action="store_true",
                    help="bounded sweep: first page size only, "
                         "budget<=8, reps<=2")
    ap.add_argument("--dry-run", action="store_true",
                    help="enumerate + prune only; nothing is benchmarked "
                         "or persisted")
    ap.add_argument("--no-save", action="store_true",
                    help="benchmark but do not write the cache")
    args = ap.parse_args()

    ops = tuple(o.strip() for o in args.ops.split(",") if o.strip())
    bad = [o for o in ops if o not in at.OPS]
    if bad:
        ap.error(f"unknown ops {bad}; choose from {at.OPS}")
    page_sizes = [int(p) for p in args.page_sizes.split(",") if p.strip()]
    budget, reps = args.budget, args.reps
    if args.smoke:
        page_sizes = page_sizes[:1]
        budget = min(budget or 8, 8)
        reps = min(reps, 2)
    sweep(args.arch, ops=ops, page_sizes=page_sizes, b=args.b, lq=args.lq,
          pages=args.pages, budget=budget, reps=reps, seed=args.seed,
          device=args.device, dtype=_DTYPES[args.dtype], out=args.out,
          save=not args.no_save, dry_run=args.dry_run)


if __name__ == "__main__":
    main()
