"""Device and host timing on the card, shared by ``chip_smoke.py`` and
:mod:`repro_torch.launch.serve_ab`.

Each helper takes ``fn(i)``, a call to time given its index ``i`` (so a
timed loop can walk layers), and needs a CUDA device.
"""
from __future__ import annotations

import statistics
import time

import torch


def time_ms(fn, calls: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``calls`` launches, by CUDA
    events (after a warm-up): device time plus whatever the host adds."""
    fn(0)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def graph_ms(fn, calls: int, reps: int = 5) -> float:
    """Device time per call, without host time: ``calls`` calls captured
    in one CUDA graph after a warm-up on a side stream, the graph replayed
    between CUDA events; the median of ``reps`` replays over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(samples)


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call, in us: ``calls`` calls enqueued back to back,
    timed on the host clock before the device has finished them."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6
