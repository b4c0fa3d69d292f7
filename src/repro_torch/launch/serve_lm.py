"""Batched serving example: slot-based continuous batching over the
device-resident decode loop, with one token dump a request, from
``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen2-0.5b
"""
from __future__ import annotations

import argparse

from .serve import run


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain path")
    args = ap.parse_args(argv)
    out = run(args.arch, reduced=True, requests=args.requests,
              max_new=args.max_new, batch=args.batch, max_len=64,
              sync_every=args.sync_every, temperature=args.temperature,
              device=args.device)
    for rid, toks in sorted(out["results"].items()):
        print(f"request {rid}: {toks}")
    return out


if __name__ == "__main__":
    main()
