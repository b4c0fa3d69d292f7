"""Serve tok/s and the decode wrappers' host time of one source tree, so
that two trees (a change and its parent) can be compared on one card.

  python src/repro_torch/launch/serve_ab.py [--src DIR] \\
      [--arch qwen2-0.5b] [--layouts paged dense] [--reps 2]

Imports ``repro_torch`` from ``--src``, a tree's ``src`` directory (by
default the one this file lies in), so a parent commit unpacked with
``git archive`` runs through the same measurement; run it as a file, not
with ``-m``.  It times, at the serve cell's attention geometry in bf16
(batch 8, slot lengths 65-576), the host time of one call of each decode
wrapper (200 calls enqueued back to back, on the host clock; the least
and the median of 7 such runs), then serves
the cell of ``chip_smoke.py`` (16 requests, prompts of 64-512 tokens, 64
new tokens each, batch 8, max_len 1024, pages of 16, 8 steps per host
sync, seeded random weights) ``--reps`` times for each layout, after one
short run that warms up.  The weights are built once.  The last line is
a JSON summary.  Compare two trees in one machine, alternating them over
several processes: tok/s is host-bound, and the host's speed drifts over
minutes.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call, in us: ``calls`` calls enqueued back to back,
    timed on the host clock before the device has finished them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def wrapper_host_us(torch, cfg, reps: int = 7) -> dict:
    """Host us a call of ``paged_attn_cuda`` (a table of 64 pages of 16)
    and ``decode_attn_cuda`` (stripes of 1,025 rows, s_cap 1,024): the
    least and the median of ``reps`` runs of :func:`host_us` (a busy host
    only adds time, so the least is the wrapper's own cost)."""
    import numpy as np
    from repro_torch.kernels.decode_attn import kernel as dkernel
    from repro_torch.kernels.paged_attn import kernel as pkernel
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    b, hq, hkv, d = 8, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16
    lengths = torch.tensor(rng.integers(65, 577, size=b), dtype=torch.int32,
                           device=dev)
    q = torch.randn(b, hq, d, device=dev).to(bf16)
    pool = torch.randn(2, 512, 16, hkv, d, device=dev).to(bf16)
    table = torch.tensor(rng.permutation(512)[:b * 64].reshape(b, 64),
                         dtype=torch.int32, device=dev)
    stripes = torch.randn(2, b, 1025, hkv, d, device=dev).to(bf16)
    calls = {
        "paged_decode": lambda: pkernel.paged_attn_cuda(
            q, pool[0], pool[1], table, lengths),
        "decode_attn": lambda: dkernel.decode_attn_cuda(
            q, stripes[0], stripes[1], lengths, 1024)}
    out = {}
    for name, fn in calls.items():
        runs = [host_us(torch, fn) for _ in range(reps)]
        out[name] = {"least": min(runs), "median": statistics.median(runs)}
    return out


def main() -> None:
    here = pathlib.Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(here),
                    help="the src directory of the tree to measure")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layouts", nargs="+", default=["paged", "dense"],
                    choices=["paged", "dense"])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    src = str(pathlib.Path(args.src).resolve())
    sys.path[0] = src          # this file's directory, when run as a file
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    from repro_torch.models.model_zoo import Model
    if pathlib.Path(repro_torch.__file__).resolve().parents[1] != \
            pathlib.Path(src):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not from {src}")
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab measures the GPU: no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    host = wrapper_host_us(torch, cfg)
    print(f"[serve_ab] {src}: wrapper host us a call {host}", flush=True)
    params = Model(cfg).init(0, device=dev, dtype=torch.bfloat16)
    tok_s = {}
    for layout in args.layouts:
        paged = layout == "paged"
        kw = dict(batch=8, max_len=1024, paged=paged, page_size=16,
                  sync_every=8, seed=0, dtype=torch.bfloat16, device=dev,
                  params=params)
        run(cfg, requests=2, max_new=8, prompt_len=(64, 65), **kw)
        tok_s[layout] = [run(cfg, requests=16, max_new=64,
                             prompt_len=(64, 513), **kw)["tok_per_s"]
                         for _ in range(args.reps)]
    print(json.dumps({"src": src, "arch": cfg.name,
                      "device": torch.cuda.get_device_name(dev),
                      "host_us": host, "tok_per_s": tok_s}))


if __name__ == "__main__":
    main()
