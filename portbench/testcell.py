"""A cell shrunk to a size the CPU runs in seconds, for the benchmark's
own tests: the same harness, traffic kind, batcher and check, on the
configuration's layer kinds at smoke widths (``ArchConfig.reduced()``'s
sizes), float32, four slots and short prompts.

    python3 -m portbench.testcell starcoder2.completion_open 3

runs one such cell on the CPU and prints its result line and the
top-level names of every module the process loaded.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

from . import spec, traffic


def tiny_port(name: str, port: dict) -> dict:
    """``port`` at smoke widths, every segment kind kept (two layers of
    each segment at most): the attention and MLP widths and the vocab
    shrunk, GQA's grouping kept (MHA stays MHA), the routed experts cut
    to 8 top-2 at a capacity nothing reaches, and the ``mla`` and ``ssm``
    blocks and
    ``shared_attn_every`` at the port's ``ArchConfig.reduced()`` sizes."""
    out = dict(port, d_model=64, n_heads=4, head_dim=16, d_ff=128,
               vocab=256)
    out["kv_heads"] = 4 if port["kv_heads"] == port["n_heads"] else 2
    out["segments"] = [[kind, min(n, 2)] for kind, n in port["segments"]]
    out["n_layers"] = sum(n for _, n in out["segments"])
    # the routed experts are cut here, so the probe leaves them out
    small = spec.arch(name, dict(port, moe=None)).reduced()
    for key in ("mla", "ssm"):
        if port.get(key):
            block = dataclasses.asdict(getattr(small, key))
            out[key] = {k: None if v is None else block[k]
                        for k, v in port[key].items()}
    if port.get("shared_attn_every"):
        out["shared_attn_every"] = small.shared_attn_every
    moe = port.get("moe")
    if moe:
        n = min(8, moe["n_experts"])
        out["moe"] = dict(moe, n_experts=n, top_k=min(2, moe["top_k"]),
                          d_ff_expert=64, d_ff_shared=64,
                          capacity_factor=8.0)
    return out


def tiny_cell(workload: str, limit: float | None = None,
              root=spec.ROOT) -> spec.Cell:
    cell = spec.cell(workload, root)
    cell.config = dict(cell.config, port=tiny_port(cell.config_name,
                                                   cell.port))
    if limit is not None:
        cell.limits = {"logit_gap_max": {"limit": limit},
                       "logit_gap_mean": {"limit": limit}}
    cell.limits = dict(cell.limits, sample_requests=4, min_tokens=10)
    return cell


def tiny_mix(cell: spec.Cell) -> traffic.Mix:
    mix = traffic.Mix.load(spec.traffic_path(cell.traffic))
    return dataclasses.replace(
        mix, slots=4, max_len=64, queue_depth=4, total_pages=None,
        prompt_tokens={"dist": "log_uniform", "lo": 8, "hi": 24},
        output_tokens={"dist": "log_uniform", "lo": 4, "hi": 16},
        ramp_s=0.3, rate_per_s=25.0, block=32)


def run_tiny(workload: str, seed: int, *, seconds: float = 0.6,
             limit: float | None = None, check_fn=None,
             cell: spec.Cell | None = None) -> dict:
    """One run of ``tiny_cell(workload, limit)`` (or of ``cell``) on the
    CPU."""
    import torch

    from . import harness
    cell = cell or tiny_cell(workload, limit)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))    # beside other test workers
    try:
        out = harness.run_cell(cell, seed=seed, seconds=seconds,
                               traced=False, device=torch.device("cpu"),
                               t_start=time.perf_counter(),
                               dtype=torch.float32, mix=tiny_mix(cell),
                               check_fn=check_fn)
    finally:
        torch.set_num_threads(threads)
    out.pop("_run")
    return out


if __name__ == "__main__":
    result = run_tiny(sys.argv[1], int(sys.argv[2]), limit=1e-3)
    print(json.dumps(result))
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
