"""Discovery: everything a cell needs, found by the names in
``BENCHMARK.json``.

- a configuration: ``portbench/configs/<config>.json`` (the file named in
  ``configs[].file``), whose ``port`` block is what the program runs;
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a metric: ``portbench/metrics/<metric name>.py``, a reader with
  ``read(run) -> float | None``;
- the limits of a cell's correctness check:
  ``portbench/limits/<workload>.json``.

A later cell is a new traffic file (and limits file) plus a ``workloads``
entry; a later metric is a new reader file plus a metric entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str                      # "end_to_end" or "per_layer"
    workloads: list[str] | None
    moves: str | None = None
    layer: str | None = None

    def applies(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads

    def reader(self):
        path = HERE / "metrics" / f"{self.name}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{self.name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod


@dataclasses.dataclass
class Cell:
    workload: str
    config_name: str
    traffic: str
    chips: int
    config: dict                   # the configuration file
    metrics_e2e: list[Metric]
    metrics_layer: list[Metric]
    limits: dict

    @property
    def port(self) -> dict:
        return self.config["port"]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metrics(bench: dict) -> list[Metric]:
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            out.append(Metric(m["name"], m["unit"], m["better"],
                              m["source"], kind, m.get("workloads"),
                              m.get("moves"), m.get("layer")))
    return out


def cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text())
    ms = [m for m in metrics(bench) if m.applies(workload)]
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]),
                config, [m for m in ms if m.kind == "end_to_end"],
                [m for m in ms if m.kind == "per_layer"], limits)


def traffic_path(name: str) -> pathlib.Path:
    return HERE / "traffic" / f"{name}.json"
