"""The main path's three leftovers: the serving example's token dump, the
flight-recorder drill and the 100M-param training profile.

* ``launch.serve_lm`` dumps ``launch.serve.run``'s results, one line a
  request, as ``examples/serve_lm.py`` does.
* ``launch.flight_drill.drill`` crashes the scheduler through a real
  ``PageError`` and returns no failure; its gate reports a bundle with a
  section removed, a wrong schema, an empty ring and a pool that does not
  cover its pages.
* ``launch.train_lm.hundred_m()`` equals ``examples/train_lm.py``'s field
  for field, and ``launch.train.run`` takes a ``reduced()`` copy of it.
"""
import contextlib
import copy
import dataclasses
import enum
import importlib.util
import io
import json
import pathlib

import pytest
import torch

from repro_torch.launch import flight_drill, serve_lm, train_lm
from repro_torch.launch.serve import run as serve_run
from repro_torch.launch.train import run as train_run

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_serve_lm_dumps_serve_run_results():
    argv = ["--requests", "3", "--max-new", "4", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = serve_lm.main(argv)
        want = serve_run("qwen2-0.5b", reduced=True, requests=3, max_new=4,
                         batch=4, max_len=64, sync_every=8, temperature=0.0,
                         device="cpu")
    assert got["results"] == want["results"]
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("request ")]
    assert lines == [f"request {rid}: {toks}"
                     for rid, toks in sorted(want["results"].items())]


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    path = tmp_path_factory.mktemp("flight") / "bundle.json"
    with contextlib.redirect_stdout(io.StringIO()):
        failures = flight_drill.drill(str(path), device="cpu")
    return failures, json.loads(path.read_text())


def test_flight_drill_passes(bundle):
    failures, data = bundle
    assert failures == []
    assert flight_drill.check_bundle(data) == []
    assert "PageError" in data["error"] and data["events"]


@pytest.mark.parametrize("break_it,expect", [
    (lambda b: b.pop("slot_table"), "slot_table"),
    (lambda b: b.update(schema=2), "schema"),
    (lambda b: b.update(events=[]), "event ring is empty"),
    (lambda b: b["pool"]["free"].pop(), "partitions cover"),
])
def test_flight_gate_reports_a_broken_bundle(bundle, break_it, expect):
    data = copy.deepcopy(bundle[1])
    break_it(data)
    failures = flight_drill.check_bundle(data)
    assert failures and any(expect in f for f in failures), failures


def _jax_hundred_m():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_example", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.hundred_m()


def _fields(obj):
    """A dataclass's fields as plain values (enums by value, nested
    dataclasses and tuples walked)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_fields(v) for v in obj]
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


def test_hundred_m_equals_jax_field_for_field():
    got, want = train_lm.hundred_m(), _jax_hundred_m()
    assert _fields(got) == _fields(want)
    assert (got.name, got.n_layers, got.d_model, got.n_heads) == (
        "qwen2-100m", 12, 640, 10)
    assert got.resolved_segments() and len(got.resolved_segments()) == len(
        want.resolved_segments())


def test_train_run_takes_a_reduced_hundred_m(tmp_path):
    cfg = train_lm.hundred_m().reduced()
    with contextlib.redirect_stdout(io.StringIO()):
        out = train_run(cfg, steps=2, batch=2, seq=16, device="cpu",
                        ckpt_dir=str(tmp_path), ckpt_every=1)
    assert len(out["losses"]) == 2
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    from repro_torch.checkpoint import Checkpointer
    _, manifest = Checkpointer(tmp_path).restore(out["state"])
    assert manifest["step"] == 2 and manifest["extra"]["arch"] == cfg.name
