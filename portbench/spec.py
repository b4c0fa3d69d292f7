"""Discovery: everything a cell needs, found by the names in
``BENCHMARK.json``.

- a configuration: ``portbench/configs/<config>.json`` (the file named in
  ``configs[].file``), whose ``port`` block is what the program runs
  (:func:`arch` turns it into the port's ``ArchConfig``) and whose
  ``reference`` key names its plain reference,
  ``portbench/reference/<reference>.py`` (default ``model``);
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a metric: ``portbench/metrics/<metric name>.py``, a reader with
  ``read(run) -> float | None``;
- the limits of a cell's correctness check:
  ``portbench/limits/<workload>.json``.

A later cell is a new traffic file (and limits file) plus a ``workloads``
entry; a later configuration a new configuration file (and, for layer
kinds no reference has, a new reference) plus a ``configs`` entry; a
later metric is a new reader file plus a metric entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import types

from . import flops

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# keys of a ``port`` block that the benchmark reads itself, not the port's
# ``ArchConfig`` (the serving dtype)
BENCH_KEYS = ("dtype",)
# ``port`` keys that hold a block of the port's own
BLOCKS = {"moe": "MoeConfig", "mla": "MlaConfig", "ssm": "SsmConfig"}


def _load(path: pathlib.Path, name: str) -> types.ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def arch(name: str, port: dict):
    """The port's ``ArchConfig`` for a configuration's ``port`` block.

    Each key sets the ``ArchConfig`` field of its name: ``segments``
    through ``BlockKind``'s values (``dense``, ``moe``, ``ssm``,
    ``shared``), ``attn`` through ``AttnKind``'s (``gqa``, ``mla``), and
    the ``moe``, ``mla`` and ``ssm`` blocks into ``MoeConfig``,
    ``MlaConfig`` and ``SsmConfig`` by their field names.  The keys in
    ``BENCH_KEYS`` are the benchmark's.  Any other key raises a
    ``ValueError`` that names it: dropping it would run another model."""
    from repro_torch.configs import base
    kw = {}
    for key, value in port.items():
        if key in BENCH_KEYS:
            continue
        _known(key, base.ArchConfig, {"name"})
        if key == "segments":
            value = tuple(base.Segment(base.BlockKind(kind), n)
                          for kind, n in value)
        elif key == "attn":
            value = base.AttnKind(value)
        elif key in BLOCKS and value is not None:
            cls = getattr(base, BLOCKS[key])
            for sub in value:
                _known(f"{key}.{sub}", cls)
            value = cls(**value)
        kw[key] = value
    return base.ArchConfig(name=name, **kw)


def _known(key: str, cls, exclude=frozenset()) -> None:
    field = key.rsplit(".", 1)[-1]
    names = {f.name for f in dataclasses.fields(cls)} - set(exclude)
    if field not in names:
        raise ValueError(f"port key {key!r} is not a field of the port's "
                         f"{cls.__name__}")


def reference(name: str, where: pathlib.Path = HERE / "reference"):
    """The plain reference ``<where>/<name>.py``, loaded by file (its
    contract: ``reference/__init__.py``)."""
    return _load(where / f"{name}.py", f"portbench_reference_{name}")


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
        return _load(HERE / "metrics" / f"{self.name}.py",
                     f"portbench_metric_{self.name.replace('.', '_')}")


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
    reference: types.ModuleType     # the plain reference the config names

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
    """The cell ``workload`` of ``<root>/BENCHMARK.json``, its limits and
    reference found under ``<root>/portbench``."""
    bench = load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    own = root / HERE.name
    limits = json.loads((own / "limits" / f"{workload}.json").read_text())
    # a layer kind the yardstick does not count is refused here, before
    # any work, not after the window
    flops.Shapes.of(config["port"])
    ms = [m for m in metrics(bench) if m.applies(workload)]
    ref = reference(config.get("reference", "model"), own / "reference")
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]),
                config, [m for m in ms if m.kind == "end_to_end"],
                [m for m in ms if m.kind == "per_layer"], limits, ref)


def traffic_path(name: str) -> pathlib.Path:
    return HERE / "traffic" / f"{name}.json"
