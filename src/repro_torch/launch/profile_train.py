"""Where a train step's time goes, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \
      [--arch qwen2-0.5b] [--seq 4096] [--batch 8] [--accum 2]

Builds the seeded float32 train state of ``--arch`` at full width
(``profile_step`` also takes an ``ArchConfig``, e.g. one cut in depth),
runs ``--warmup`` train steps of ``TrainConfig``'s defaults (bf16
activations, remat) on the port's ``DataPipeline`` batches, then one
more untraced and one under ``torch.profiler``. It prints: the step's
wall time (host clock, synchronised), untraced and traced; device busy
time (the sum of the device events' times: one stream); the device's
idle share against the untraced wall; kernels a step; the device time
by kind of kernel (matrix products, the grouped expert GEMM, softmax,
elementwise, reductions, copies, the rest; by kernel name); and the
kernels that take the most device time. The last line is a JSON
summary. ``--trace PATH`` also writes the Chrome trace.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..configs.base import ArchConfig
from ..data import DataConfig, DataPipeline
from ..device import resolve_device
from ..models.model_zoo import Model
from ..train.train_loop import (TrainConfig, make_train_state,
                                make_train_step, split_microbatches)
from .profile_serve import _device_us

# kinds of kernel by a substring of the lower-cased name, first match wins
KINDS = (("group_gemm", ("group_gemm",)),
         ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
         ("softmax", ("softmax",)),
         ("copy", ("copy", "memcpy", "memset", "catarray")),
         ("reduce", ("reduce",)),
         ("elementwise", ("elementwise",)))


def kind_of(name: str) -> str:
    name = name.lower()
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def profile_step(arch: str | ArchConfig = "qwen2-0.5b", *, seq: int = 4096,
                 batch: int = 8, accum: int = 2, warmup: int = 1,
                 seed: int = 0, device: str = "cuda",
                 trace: str | None = None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profiling measures the GPU: device must be cuda")
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    model = Model(cfg)
    tcfg = TrainConfig(accum=accum)
    state = make_train_state(model, seed, tcfg, device=dev)
    step_fn = make_train_step(model, tcfg)
    data = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=batch, seed=seed))

    def step(i):
        nonlocal state
        tokens = torch.from_numpy(data.batch_at(i)["tokens"]).to(dev)
        state, metrics = step_fn(
            state, split_microbatches({"tokens": tokens}, accum))
        return float(metrics["loss"])

    for i in range(warmup):
        step(i)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    step(warmup)
    torch.cuda.synchronize(dev)
    wall_plain = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(warmup + 1)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    busy_us = sum(_device_us(e) for e in kernels)
    by_kind: dict[str, float] = {}
    for e in kernels:
        k = kind_of(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + _device_us(e) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    summary = {
        "device": torch.cuda.get_device_name(dev), "arch": cfg.name,
        "tokens": batch * seq, "accum": accum,
        "wall_ms": wall_plain * 1e3, "wall_ms_traced": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_plain),
        "kernels": sum(e.count for e in kernels),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "device_ms_by_kind": dict(sorted(by_kind.items(),
                                         key=lambda kv: -kv[1])),
        "top": [{"kernel": e.key[:80], "ms": _device_us(e) / 1e3,
                 "calls": e.count} for e in top]}
    print(f"[profile] {cfg.name} train step, {batch} x {seq} tokens in "
          f"{accum} microbatches on {summary['device']}: wall "
          f"{summary['wall_ms']:.1f} ms ({summary['wall_ms_traced']:.1f} "
          f"traced), device busy {summary['device_busy_ms']:.1f} ms, idle "
          f"share {summary['idle_share']:.1%}, {summary['kernels']} "
          f"kernels, peak {summary['peak_gib']:.2f} GiB")
    print("[profile]   device ms by kind: " + ", ".join(
        f"{k} {v:.1f}" for k, v in summary["device_ms_by_kind"].items()))
    for row in summary["top"]:
        print(f"[profile]   {row['ms']:.2f} ms ({row['calls']} calls)  "
              f"{row['kernel']}")
    if trace:
        prof.export_chrome_trace(trace)
    print(json.dumps(summary))
    return summary


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--trace", default=None, metavar="PATH")
    args = ap.parse_args()
    profile_step(args.arch, seq=args.seq, batch=args.batch,
                 accum=args.accum, warmup=args.warmup, trace=args.trace)


if __name__ == "__main__":
    main()
