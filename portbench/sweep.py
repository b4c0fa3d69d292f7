"""The rate sweep that finds an open-loop cell's knee, on the card.

    python3 -m portbench.sweep --workload starcoder2.completion_open \\
        --rates 0.5,1,1.5,2 --seconds 40 --seed 5

Runs the cell once a rate, in one process, with the traffic file's rate
replaced, and prints one JSON line a rate: arrivals in the window, those
finished, the requests waiting for their first token when the window
opened and when it closed, and TTFT's median and 95th percentile over
the window's first and second halves.  A rate is sustained when the
waiting requests do not grow over the window and the second half's TTFT
does not run away from the first's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from portbench.run import ROOT, _env


def _waiting(session, t: float) -> int:
    return sum(1 for q in session.window_reqs()
               if q.t_arrival <= t and (q.t_first is None or q.t_first > t))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    _env()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from portbench import harness, spec, traffic
    device = torch.device("cuda", 0)
    harness.DRAIN_S = 0.0        # the window alone says whether it keeps up
    cell = spec.cell(args.workload, ROOT)
    base = traffic.Mix.load(spec.traffic_path(cell.traffic))
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dataclasses.replace(base, rate_per_s=rate)
        t0 = time.perf_counter()
        out = harness.run_cell(
            cell, seed=args.seed, seconds=args.seconds, traced=False,
            device=device, t_start=t0, mix=mix,
            check_fn=lambda *a: {"correct": True, "checks": {}})
        run = out.pop("_run")
        s = run.session
        mid = (s.w0 + s.w1) / 2
        halves = {}
        for name, a, b in (("first", s.w0, mid), ("second", mid, s.w1)):
            ttft = [q.t_first - q.t_arrival for q in s.window_reqs()
                    if a <= q.t_arrival < b and q.t_first is not None]
            halves[name] = ([float(np.percentile(ttft, p)) for p in (50, 95)]
                            if ttft else None)
        print(json.dumps({
            "rate": rate, "attempted": out["attempted"],
            "failed": out["failed"],
            "waiting_at_open": _waiting(s, s.w0),
            "waiting_at_close": _waiting(s, s.w1),
            "ttft_s_p50_p95": halves,
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "joins_share": ((s.join1["mean_join_s"] * s.join1["joins"]
                             - s.join0["mean_join_s"] * s.join0["joins"])
                            / run.window_s),
            "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
