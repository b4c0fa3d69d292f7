"""Where a decode segment's time goes, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--paged] \
      [--arch moonshot-v1-16b-a3b] [--eager] [--speculate K]

Fills every slot of the batcher with the serve cell's requests
(``--arch`` at full width, qwen2-0.5b by default; ``profile_decode``
also takes an ``ArchConfig``, e.g. one cut in depth; seeded bf16 weights
built in place, prompts of 64-512 tokens, max_len 1024; dense stripes,
or pages of 16 with ``--paged``), joins them, runs one decode segment to
warm up (with graphs, the default, that segment is the bucket's eager
warm-up and its capture; ``--eager`` runs every segment kernel by
kernel), then traces ``--segments`` more under ``torch.profiler``
(with ``--speculate K``, paged only, every step is a draft-K verify
step, and the tokens it commits a step are printed too); a
capture inside the timed segments fails the run. Each segment is the
serving path's own: the decode loop (a graph replay, or the eager loop),
the one host read of its tokens and their collection. It prints: wall
time per decode step (host clock, synchronised), once without the tracer
and once under it; device busy time per step (sum of the device events'
times on the one stream, from the traced run: the kernels a replayed
graph runs are traced one by one, as CUPTI reports them); the device's
idle share against each of the two walls (the untraced one is the
serving path's own; the tracer slows the host); device kernels (and
copies) per step; host launch calls per step (the CUDA calls that
launch a kernel or a graph: ``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel*``, ``cudaGraphLaunch``); the
kernels that take the most device time; and the host ops that take the
most CPU time under the tracer. The last line is a JSON summary.
``--trace PATH`` also writes the Chrome trace.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models.model_zoo import Model
from ..serve.engine import ServeConfig
from ..serve.scheduler import Batcher


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cuGraphLaunch")


def profile_decode(arch: str | ArchConfig = "qwen2-0.5b", *, batch: int = 8,
                   max_len: int = 1024, page_size: int = 16,
                   sync_every: int = 8, segments: int = 2,
                   prompt_len: tuple[int, int] = (64, 513), seed: int = 0,
                   paged: bool = False, graphs: bool = True,
                   device: str = "cuda", trace: str | None = None,
                   speculate_k: int | None = None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profiling measures the GPU: device must be cuda")
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    model = Model(cfg)
    params = model.init(seed, device=dev, dtype=torch.bfloat16)
    scfg = ServeConfig(max_len=max_len, batch=batch, sync_every=sync_every,
                       paged=paged, page_size=page_size,
                       speculate_k=speculate_k)
    # nobody retires mid-run, though a verify step commits up to k+1
    max_new = sync_every * (2 * segments + 2) * ((speculate_k or 0) + 1)
    b = Batcher(model, params, scfg, seed=seed, graphs=graphs)
    rng = np.random.default_rng(seed)
    for rid in range(batch):
        n = int(rng.integers(*prompt_len))
        b.submit(rid, rng.integers(0, cfg.vocab, size=n).tolist())
    b._refill(max_new)

    def segment():
        b._collect(b._decode_segment(sync_every).cpu().numpy())

    segment()
    torch.cuda.synchronize(dev)
    captured = b.graph_count
    t0 = time.perf_counter()
    for _ in range(segments):
        segment()
    torch.cuda.synchronize(dev)
    wall_plain = time.perf_counter() - t0
    committed = b.metrics.value("spec.emitted")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(segments):
            segment()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if b.graph_count != captured:
        raise RuntimeError("a decode graph was captured inside the timed "
                           "segments: the bucket changed after the warm-up")
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
    n_host_launch = sum(e.count for e in host
                        if e.key.startswith(_LAUNCH_CALLS))
    summary = {
        "device": torch.cuda.get_device_name(dev),
        "layout": "paged" if paged else "dense",
        "mode": f"{b.graph_count} CUDA graphs" if graphs else "eager",
        "steps": steps, "batch": batch, "speculate_k": speculate_k,
        "tokens_per_step": ((b.metrics.value("spec.emitted") - committed)
                            / steps if speculate_k else float(batch)),
        "wall_ms_per_step": wall_plain * 1e3 / steps,
        "wall_ms_per_step_traced": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_plain),
        "idle_share_traced": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "kernels_per_step": n_launch / steps,
        "host_launches_per_step": n_host_launch / steps,
        "top": [{"kernel": e.key[:80], "ms_per_step":
                 _device_us(e) / 1e3 / steps, "calls_per_step":
                 e.count / steps} for e in top],
        "top_host_ops_traced": [{"op": e.key[:60], "cpu_ms_per_step":
                                 e.self_cpu_time_total / 1e3 / steps,
                                 "calls_per_step": e.count / steps}
                                for e in host[:12]]}
    kind = (f"verify steps (k {speculate_k}, "
            f"{summary['tokens_per_step']:.2f} tokens committed a step "
            "over the batch)"
            if speculate_k else "decode steps")
    print(f"[profile] {cfg.name} {summary['layout']} "
          f"({summary['mode']}), batch {batch}, "
          f"{steps} {kind} on "
          f"{summary['device']}: wall {summary['wall_ms_per_step']:.2f} "
          f"ms/step ({summary['wall_ms_per_step_traced']:.2f} traced), "
          f"device busy {summary['device_busy_ms_per_step']:.2f} ms/step, "
          f"idle share {summary['idle_share']:.1%} "
          f"({summary['idle_share_traced']:.1%} of the traced wall), "
          f"{summary['kernels_per_step']:.0f} kernels/step, "
          f"{summary['host_launches_per_step']:.3f} host launch calls/step")
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
    ap.add_argument("--eager", action="store_true",
                    help="run the decode loop kernel by kernel (default: "
                         "replay one CUDA graph per bucket)")
    ap.add_argument("--speculate", type=int, default=None, metavar="K",
                    help="profile the draft-K verify loop (needs --paged)")
    ap.add_argument("--trace", default=None, metavar="PATH")
    args = ap.parse_args()
    profile_decode(args.arch, batch=args.batch, segments=args.segments,
                   sync_every=args.sync_every, paged=args.paged,
                   graphs=not args.eager, trace=args.trace,
                   speculate_k=args.speculate)


if __name__ == "__main__":
    main()
