"""Serve tok/s and the decode wrappers' host time, or the device times of
the primitive ops, of one source tree, so that two trees (a change and
its parent) can be compared on one card.

  python src/repro_torch/launch/serve_ab.py [--src DIR] \\
      [--arch qwen2-0.5b] [--layouts paged dense] [--reps 2]
  python src/repro_torch/launch/serve_ab.py --primitives [--src DIR] \\
      [--steps 5]

Imports ``repro_torch`` from ``--src``, a tree's ``src`` directory (by
default the one this file lies in), so a parent commit unpacked with
``git archive`` runs through the same measurement; run it as a file, not
with ``-m``.  The timing helpers are always this file's own tree's
(``timing.py`` beside it), whichever tree is measured.

Serve (the default): it times, at the serve cell's attention geometry in
bf16 (batch 8, slot lengths 65-576), the host time of one call of each
decode wrapper (200 calls enqueued back to back, on the host clock; the
least and the median of 7 such runs), then serves the cell of
``chip_smoke.py`` (16 requests, prompts of 64-512 tokens, 64 new tokens
each, batch 8, max_len 1024, pages of 16, 8 steps per host sync, seeded
random weights) ``--reps`` times for each layout, after one short run
that warms up.  The weights are built once.  Compare two trees in one
machine, alternating them over several processes: tok/s is host-bound,
and the host's speed drifts over minutes.

``--primitives``: at ``wavesim.Problem()`` (R = 1,728,000 rows of 27), in
float32 and bfloat16, the public op ``wavesim_volume.volume`` and
``torch.matmul(x, W)``; at 64 Mi float16 elements, ``vector_sum`` and
``torch.add``.  Each is timed twice: 20 calls captured in one CUDA graph
and replayed (device time, ``graph_ms``), and 20 calls enqueued back to
back between CUDA events (``ms``, which includes the host); the median of
5 replays or runs.  Then ``--steps`` wave steps at ``Problem()`` through
``launch.wave_demo.run`` (ms a step and the volume op's ms, medians).

The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import sys


def own_timing():
    """``timing.py`` of this file's tree, loaded by path: ``--src`` may
    name a tree that has no such module."""
    path = pathlib.Path(__file__).resolve().with_name("timing.py")
    spec = importlib.util.spec_from_file_location("serve_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wrapper_host_us(torch, timing, cfg, reps: int = 7) -> dict:
    """Host us a call of ``paged_attn_cuda`` (a table of 64 pages of 16)
    and ``decode_attn_cuda`` (stripes of 1,025 rows, s_cap 1,024): the
    least and the median of ``reps`` runs of ``timing.host_us`` (a busy
    host only adds time, so the least is the wrapper's own cost)."""
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
        "paged_decode": lambda i: pkernel.paged_attn_cuda(
            q, pool[0], pool[1], table, lengths),
        "decode_attn": lambda i: dkernel.decode_attn_cuda(
            q, stripes[0], stripes[1], lengths, 1024)}
    out = {}
    for name, fn in calls.items():
        runs = [timing.host_us(fn) for _ in range(reps)]
        out[name] = {"least": min(runs), "median": statistics.median(runs)}
    return out


def serve(torch, timing, args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    from repro_torch.models.model_zoo import Model
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    host = wrapper_host_us(torch, timing, cfg)
    print(f"[serve_ab] {args.src}: wrapper host us a call {host}",
          flush=True)
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
    return {"arch": cfg.name, "host_us": host, "tok_per_s": tok_s}


def primitives(torch, timing, args) -> dict:
    from repro_torch.core.primitives import wavesim
    from repro_torch.kernels import vector_sum as vs
    from repro_torch.kernels import wavesim_volume as wv
    from repro_torch.launch import wave_demo

    def both(fn) -> dict:
        return {"graph_ms": timing.graph_ms(lambda i: fn(), 20),
                "ms": timing.time_ms(lambda i: fn(), 20)}
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    prob = wavesim.Problem()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.randn(prob.n_elements, prob.n_fields, 3, 3, 3,
                        generator=gen, device="cuda").to(dtype)
        x = u.view(-1, 27)
        w = wv.fused_operator(1.0, dtype).cuda()
        name = str(dtype).split(".")[1]
        out[f"volume_{name}"] = both(lambda: wv.volume(u))
        out[f"matmul_{name}"] = both(lambda: torch.matmul(x, w))
        del u, x
    n = 64 << 20
    a = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    b = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    out["vector_sum_float16"] = both(lambda: vs.vector_sum(a, b))
    out["add_float16"] = both(lambda: torch.add(a, b))
    del a, b
    res = wave_demo.run(prob.grid, prob.n_fields, args.steps,
                        wave_demo.DEMO_DT, device="cuda", seed=0,
                        verbose=False)
    out["wave_step_ms"] = statistics.median(res["step_ms"])
    out["wave_volume_ms"] = statistics.median(res["volume_ms"])
    for key, val in out.items():
        if isinstance(val, dict):
            print(f"[serve_ab] {key}: device {val['graph_ms']:.4f} ms, "
                  f"events {val['ms']:.4f} ms", flush=True)
    return out


def main() -> None:
    here = pathlib.Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(here),
                    help="the src directory of the tree to measure")
    ap.add_argument("--primitives", action="store_true",
                    help="time the volume and vector-sum ops and the wave "
                         "step instead of serving")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layouts", nargs="+", default=["paged", "dense"],
                    choices=["paged", "dense"])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    args.src = str(pathlib.Path(args.src).resolve())
    timing = own_timing()
    sys.path[0] = args.src     # this file's directory, when run as a file
    import torch
    import repro_torch
    if pathlib.Path(repro_torch.__file__).resolve().parents[1] != \
            pathlib.Path(args.src):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not from {args.src}")
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab measures the GPU: no CUDA device")
    out = (primitives if args.primitives else serve)(torch, timing, args)
    print(json.dumps({"src": args.src,
                      "device": torch.cuda.get_device_name(0), **out}))


if __name__ == "__main__":
    main()
