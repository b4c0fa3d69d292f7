"""The readings a cell's correctness limit is set from, on the card.

    python3 -m portbench.calibrate --workload moonshot.decode_backlog \\
        --seeds 11,12,13 --seconds 20 [--control]

For each seed, in one process: a run of the cell at its own load for
``--seconds`` (set-up, ramp and window as the benchmark's), then, on the
requests its check samples, the widest gap of the program's served
tokens (the lower reading) and, with ``--control``, of the control: the
cell's reference run in float8 (``fp8=True``) in the program's place,
each position's token its own first choice, read in the float32
reference (the upper reading).  One JSON line a seed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import json          # noqa: E402
import sys           # noqa: E402

from portbench.run import ROOT, _env   # noqa: E402


def _stats(name: str, gaps) -> dict:
    import numpy as np
    g = np.concatenate(gaps)
    return {name: float(g.max()), f"{name}_p99": float(np.percentile(g, 99)),
            f"{name}_mean": float(g.mean()),
            f"{name}_off_argmax": float((g > 0).mean())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    _env()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench import check, harness, spec
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        read = {}

        def reading(cell_, mix, params, session, seed_):
            reqs = check.sample(session, seed_,
                                int(cell_.limits["sample_requests"]),
                                cell_.port,
                                int(cell_.limits["min_tokens"]))
            t0 = time.perf_counter()
            g = check.gaps(cell_, params, reqs)
            read.update(_stats("program", g))
            read["tokens"] = int(sum(x.size for x in g))
            read["slots"] = sorted({q.slot for q in reqs})
            read["reference_s"] = time.perf_counter() - t0
            if args.control:
                firsts = check.gaps(cell_, params, reqs, fp8=True)
                c = check.gaps(cell_, params, reqs,
                               tokens=[f.tolist() for f in firsts])
                read.update(_stats("control", c))
            return check.check(cell_, mix, params, session, seed_)
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed=seed, seconds=args.seconds,
                               traced=False, device=device,
                               t_start=t0, check_fn=reading)
        out.pop("_run")
        print(json.dumps({"seed": seed, **read,
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "attempted": out["attempted"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
