"""Where a decode segment's time goes, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--paged]

Fills every slot of the batcher with the serve cell's requests
(full-width qwen2-0.5b, bf16, prompts of 64-512 tokens, max_len 1024;
dense stripes, or pages of 16 with ``--paged``), joins them, runs one
decode segment to warm up, then traces ``--segments`` more under
``torch.profiler``.  Each segment is the serving path's own: the decode
loop, the one host read of its tokens and their collection.  It prints: wall time per decode step (host
clock, synchronised), once without the tracer and once under it; device
busy time per step (sum of kernel times on the one stream, from the traced
run); the device's idle share against each of the two walls (the untraced
one is the serving path's own; the tracer slows the host); kernels
launched per step; the kernels that take the most device time; and the
host ops that take the most CPU time under the tracer.  The last line is a
JSON summary.  ``--trace PATH`` also writes the Chrome trace.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..device import resolve_device
from ..models.init import cast_for_serving
from ..models.model_zoo import Model
from ..serve.engine import ServeConfig
from ..serve.scheduler import Batcher


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_decode(arch: str = "qwen2-0.5b", *, batch: int = 8,
                   max_len: int = 1024, page_size: int = 16,
                   sync_every: int = 8, segments: int = 2,
                   prompt_len: tuple[int, int] = (64, 513), seed: int = 0,
                   paged: bool = False, device: str = "cuda",
                   trace: str | None = None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profiling measures the GPU: device must be cuda")
    cfg = get_config(arch)
    model = Model(cfg)
    params = cast_for_serving(model.init(seed, device=dev), torch.bfloat16)
    scfg = ServeConfig(max_len=max_len, batch=batch, sync_every=sync_every,
                       paged=paged, page_size=page_size)
    max_new = sync_every * (2 * segments + 2)  # nobody retires mid-run
    b = Batcher(model, params, scfg, seed=seed)
    rng = np.random.default_rng(seed)
    for rid in range(batch):
        n = int(rng.integers(*prompt_len))
        b.submit(rid, rng.integers(0, cfg.vocab, size=n).tolist())
    b._refill(max_new)

    def segment():
        b._collect(b._decode_segment(sync_every).cpu().numpy())

    segment()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(segments):
        segment()
    torch.cuda.synchronize(dev)
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(segments):
            segment()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    steps = segments * sync_every
    # device-side events: kernels and copies, one stream, so their sum is
    # the device's busy time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    busy_us = sum(_device_us(e) for e in kernels)
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    summary = {
        "device": torch.cuda.get_device_name(dev),
        "layout": "paged" if paged else "dense",
        "steps": steps, "batch": batch,
        "wall_ms_per_step": wall_plain * 1e3 / steps,
        "wall_ms_per_step_traced": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_plain),
        "idle_share_traced": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "kernels_per_step": n_launch / steps,
        "top": [{"kernel": e.key[:80], "ms_per_step":
                 _device_us(e) / 1e3 / steps, "calls_per_step":
                 e.count / steps} for e in top],
        "top_host_ops_traced": [{"op": e.key[:60], "cpu_ms_per_step":
                                 e.self_cpu_time_total / 1e3 / steps,
                                 "calls_per_step": e.count / steps}
                                for e in host[:12]]}
    print(f"[profile] {cfg.name} {summary['layout']}, batch {batch}, "
          f"{steps} decode steps on "
          f"{summary['device']}: wall {summary['wall_ms_per_step']:.2f} "
          f"ms/step ({summary['wall_ms_per_step_traced']:.2f} traced), "
          f"device busy {summary['device_busy_ms_per_step']:.2f} ms/step, "
          f"idle share {summary['idle_share']:.1%} "
          f"({summary['idle_share_traced']:.1%} of the traced wall), "
          f"{summary['kernels_per_step']:.0f} kernels/step")
    for row in summary["top"]:
        print(f"[profile]   {row['ms_per_step']:.3f} ms/step "
              f"({row['calls_per_step']:.0f} calls)  {row['kernel']}")
    for row in summary["top_host_ops_traced"]:
        print(f"[profile]   host (traced) {row['cpu_ms_per_step']:.3f} ms/step "
              f"({row['calls_per_step']:.0f} calls)  {row['op']}")
    if trace:
        prof.export_chrome_trace(trace)
    print(json.dumps(summary))
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="profile the paged pool (default: dense stripes)")
    ap.add_argument("--trace", default=None, metavar="PATH")
    args = ap.parse_args()
    profile_decode(args.arch, batch=args.batch, segments=args.segments,
                   sync_every=args.sync_every, paged=args.paged,
                   trace=args.trace)


if __name__ == "__main__":
    main()
