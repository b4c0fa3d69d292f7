"""The benchmark of the port (``repro_torch``) on the card.

    python3 -m portbench.run --workload moonshot.decode_backlog \\
        --seed 1234 --seconds 40 --trace 0

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; then
``checks``, each number the correctness check compared beside its limit,
which also ends standard error.  It exits non-zero and prints no result
without a CUDA card (or fewer than the cell asks for), without the
program's sources in the checkout, or when a JAX module (``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro``) was loaded.
"""
import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import pathlib       # noqa: E402
import sys           # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is a JAX one."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    nothing that would load JAX or Flax."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"[portbench] no program in this checkout ({src}/repro_torch "
              "is missing)", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    from portbench import spec
    cell = spec.cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("[portbench] no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from portbench import harness
    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              traced=bool(args.trace), device=device,
                              t_start=T_START)
    run = result.pop("_run")
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] JAX modules loaded: {bad}", file=sys.stderr)
        return 4
    for line in diagnostics(run, result):
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def diagnostics(run, result) -> list[str]:
    s = run.session
    reqs = s.window_reqs()
    done_w = sum(1 for q in reqs if q.t_done is not None
                 and s.w0 <= q.t_done < s.w1)
    late = sorted(s.late_s)
    lines = [
        f"[portbench] {run.cell.workload}: window {run.window_s:.3f} s, "
        f"set-up {run.setup_s:.3f} s, {len(reqs)} requests submitted, "
        f"{done_w} finished in the window, {sum(1 for r in s.rounds if not r.idle)} rounds, "
        f"device {result['device']['kind']}",
        "[portbench] set-up s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in run.setup_parts.items()),
        f"[portbench] metrics {json.dumps(result['metrics'])}"]
    if late:
        lines.append(f"[portbench] arrivals submitted late by p50 "
                     f"{late[len(late) // 2] * 1e3:.3f} ms, max "
                     f"{late[-1] * 1e3:.3f} ms")
    ttft, tpot = latencies(run)
    lines.append("[portbench] latency ms: " + "; ".join(
        f"{name} n {len(v)} p50 {_pct(v, 50)} p90 {_pct(v, 90)} "
        f"p95 {_pct(v, 95)}" for name, v in (("ttft", ttft),
                                           ("tpot", tpot))))
    j0, j1 = s.join0, s.join1
    if j0 and j1 and j1["joins"] > j0["joins"]:
        n = j1["joins"] - j0["joins"]
        sec = j1["mean_join_s"] * j1["joins"] - j0["mean_join_s"] * j0["joins"]
        lines.append(f"[portbench] {n} joins in the window, "
                     f"{sec:.3f} s ({sec / run.window_s:.1%} of it)")
    return lines


def latencies(run) -> tuple[list[float], list[float]]:
    """TTFT of the window's arrivals (open loop) and TPOT of the
    requests the cell's ``tpot`` metric reads, in ms."""
    s = run.session
    reqs = s.window_reqs()
    ttft = [(q.t_first - q.t_arrival) * 1e3 for q in reqs
            if s.w0 <= q.t_arrival < s.w1 and q.t_first is not None] \
        if run.mix.kind == "open" else []
    done = [q for q in reqs if q.t_done is not None and q.r.out_len > 1
            and s.w0 <= q.t_done < s.w1]
    tpot = [(q.t_done - q.t_first) / (q.r.out_len - 1) * 1e3 for q in done]
    return ttft, tpot


def _pct(values, q):
    if not values:
        return None
    import numpy as np
    return round(float(np.percentile(values, q)), 3)


if __name__ == "__main__":
    sys.exit(main())
