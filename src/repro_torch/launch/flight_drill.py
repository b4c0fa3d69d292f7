"""Flight-recorder drill: crash the scheduler on purpose, gate the bundle,
from ``scripts/flight_drill.py``.

The flight recorder (``ServeConfig.flight_recorder``) is the always-on
bounded ring the scheduler dumps when a :class:`PageError` escapes the
run loop.  Like any crash-only machinery it rots unless something
actually crashes, so this drill runs a tiny serving wave with a chaos
injector that, at a configured round, drives a *real* allocator fault
through the real pool (a second ``reserve`` for a live slot), then
validates the debug bundle the dying run wrote:

* the bundle file exists and is loadable JSON with ``schema == 1``;
* ``error`` names PageError and ``round`` is the failure round;
* the event ring is non-empty and no event's round is past the failure
  round: the recorder captured the run *up to* the fault;
* the config, slot table, pool snapshot and metrics sections are
  present, and the pool snapshot's partitions cover every page.

Exit 0 when all checks pass, 1 otherwise.

  PYTHONPATH=src python -m repro_torch.launch.flight_drill \\
      [--out flight_bundle.json] [--round N] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.model_zoo import Model
from ..serve.chaos import ChaosInjector
from ..serve.engine import ServeConfig
from ..serve.kvpool import PageError
from ..serve.scheduler import Batcher

SECTIONS = ("config", "slot_table", "pool", "metrics")


class PoolFaultInjector(ChaosInjector):
    """From ``fault_round`` on, at the first round with a live slot, issue
    a second ``reserve`` for it: the pool itself raises (the slot already
    holds pages), so the fault travels the allocator path a real
    double-mapping bug would."""

    def __init__(self, fault_round: int):
        super().__init__(check_invariants=True)
        self.fault_round = fault_round
        self.fired = False

    def on_round(self, batcher) -> None:
        super().on_round(batcher)
        if (not self.fired and batcher.round >= self.fault_round
                and batcher.pool is not None):
            live = [i for i, rid in enumerate(batcher.slot_rid)
                    if rid is not None]
            if live:
                self.fired = True
                batcher.pool.reserve(live[0], 1)


def check_bundle(bundle: dict) -> list[str]:
    """The gate's checks of a loaded bundle: the list of failures."""
    failures: list[str] = []
    if bundle.get("schema") != 1:
        failures.append(f"bundle schema {bundle.get('schema')!r} != 1")
    if "PageError" not in bundle.get("error", ""):
        failures.append(f"error field does not name PageError: "
                        f"{bundle.get('error')!r}")
    fail_round = bundle.get("round")
    events = bundle.get("events") or []
    if not events:
        failures.append("event ring is empty")
    for e in events:
        if e.get("round") is not None and e["round"] > fail_round:
            failures.append(f"event {e.get('kind')} at round {e['round']} "
                            f"postdates the failure round {fail_round}")
            break
    for section in SECTIONS:
        if not bundle.get(section):
            failures.append(f"bundle section {section!r} missing/empty")
    pool = bundle.get("pool") or {}
    if pool:
        partitions = (len(pool.get("free", []))
                      + len(pool.get("cached", []))
                      + len(pool.get("preempted", []))
                      + len(pool.get("held", []))
                      + sum(len(p) for p in pool.get("slot_pages", [])))
        if partitions != pool.get("n_pages"):
            failures.append(
                f"pool snapshot partitions cover {partitions} pages "
                f"!= n_pages {pool.get('n_pages')}")
    return failures


def drill(out_path: str, fault_round: int = 3,
          device: str | torch.device = "cuda") -> list[str]:
    """Run the forced-crash wave (reduced qwen2-0.5b, float32, paged, on
    ``device``); return the list of gate failures."""
    dev = resolve_device(device)
    cfg = get_config("qwen2-0.5b").reduced()
    model = Model(cfg)
    params = model.init(0, device=dev)
    scfg = ServeConfig(max_len=48, batch=2, dtype=torch.float32,
                       sync_every=4, paged=True, page_size=8,
                       total_pages=10, flight_path=out_path)
    b = Batcher(model, params, scfg, chaos=PoolFaultInjector(fault_round))
    rng = np.random.default_rng(0)
    for rid in range(3):
        b.submit(rid, rng.integers(0, cfg.vocab, size=10).tolist())
    try:
        b.run(max_new=8)
    except PageError as err:
        print(f"[flight_drill] PageError raised as planned: {err}")
    else:
        return ["the injected pool fault never raised: the drill is dead"]
    try:
        with open(out_path) as f:
            bundle = json.load(f)
    except (OSError, ValueError) as e:
        return [f"bundle {out_path} not loadable: {e}"]
    failures = check_bundle(bundle)
    if not failures:
        events, pool = bundle["events"], bundle["pool"]
        print(f"[flight_drill] bundle ok: {len(events)} ring events, "
              f"failure at round {bundle.get('round')}, "
              f"last event round {events[-1].get('round')}, "
              f"{len(pool.get('free', []))} free pages at death "
              f"-> {out_path}")
    return failures


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="flight_bundle.json",
                    help="where the dying run writes its debug bundle")
    ap.add_argument("--round", type=int, default=3,
                    help="scheduling round at which the pool fault fires")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain path")
    args = ap.parse_args(argv)
    failures = drill(args.out, args.round, args.device)
    if failures:
        print(f"[flight_drill] {len(failures)} failure(s):")
        for f_ in failures:
            print(f"  - {f_}")
        sys.exit(1)


if __name__ == "__main__":
    main()
