"""What the benchmark's processes load: a whole run of a cell (on the CPU,
at a test's size) loads no module whose top-level name, compared whole,
is ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
(``repro_torch`` begins with ``repro`` and is allowed); the reference
loads nothing of the port either.  Each runs in a fresh interpreter."""
import json
import os
import subprocess
import sys

import pytest

from portbench import spec

JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def _env():
    env = dict(os.environ)
    src = str(spec.ROOT / "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(spec.ROOT), src] + [p for p in env.get("PYTHONPATH", "")
                                 .split(os.pathsep) if p])
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "2"
    return env


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.testcell",
         "starcoder2.completion_open", "2"], cwd=spec.ROOT, env=_env(),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    result, names = (json.loads(x) for x in
                     out.stdout.strip().splitlines()[-2:])
    assert result["correct"]
    assert "repro_torch" in names
    assert not (set(names) & JAX_NAMES), set(names) & JAX_NAMES


def test_the_harness_modules_load_no_jax():
    names = _loaded(
        "import json, sys; import portbench.run, portbench.harness, "
        "portbench.check, portbench.spec, portbench.trace; "
        "import repro_torch.serve.scheduler, repro_torch.models.model_zoo; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not (names & JAX_NAMES)


def test_the_reference_loads_nothing_of_the_port():
    """Every module in ``reference/``, loaded as the harness loads it."""
    mods = sorted(p.stem for p in (spec.HERE / "reference").glob("*.py")
                  if p.stem != "__init__")
    assert "model" in mods
    names = _loaded(
        "import json, sys; import portbench.reference; "
        "from portbench import spec; "
        f"[(r.forward, r.COVERS) for r in map(spec.reference, {mods!r})]; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not (names & (JAX_NAMES | {"repro_torch"}))


def test_no_card_no_result(tmp_path):
    """Without a CUDA card, or in a directory holding only the benchmark,
    the command exits non-zero and prints no result."""
    import shutil

    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would measure it")
    argv = ["--workload", "starcoder2.completion_open", "--seed", "1",
            "--seconds", "1"]
    out = subprocess.run([sys.executable, "-m", "portbench.run"] + argv,
                         cwd=spec.ROOT, env=_env(), capture_output=True,
                         text=True, timeout=240)
    assert out.returncode != 0
    assert not out.stdout.strip()
    alone = tmp_path / "alone"
    shutil.copytree(spec.HERE, alone / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", alone / "BENCHMARK.json")
    env = _env()
    env["PYTHONPATH"] = str(alone)
    out = subprocess.run([sys.executable, "-m", "portbench.run"] + argv,
                         cwd=alone, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode != 0
    assert not out.stdout.strip()
