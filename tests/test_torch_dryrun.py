"""The dry-run, its trace analyzer and the roofline against the JAX
package's.

* ``param_counts``, ``n_params``, ``n_active_params`` and ``model_flops``
  are ``==`` JAX's for every (arch, shape) of ``shapes_for``.
* ``from_artifact``'s terms, given a synthetic record and the TPU's
  numbers as the spec, are ``==`` JAX's.
* The trace analyzer's dot FLOPs for a three-trip loop of two matmuls
  equal JAX's ``analyze_hlo`` on the equivalent ``lax.scan``, compiled
  on the CPU; its collective bytes follow JAX's conventions.
* On a fake 16 x 16 world one reduced cell of each kind (train, prefill,
  decode) writes a record with JAX's keys, whose per-device param bytes
  are the sum over leaves of JAX's shard bytes; ``roofline_table``
  renders the records; a failing cell fails the run.
"""
import contextlib
import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.base import shapes_for as jax_shapes_for
from repro.distributed import sharding as jshd
from repro.models import param as jpm
from repro.models.model_zoo import Model as JaxModel
from repro.roofline import analysis as janalysis
from repro.roofline.hlo_analyzer import analyze_hlo
from repro_torch.configs import get_config
from repro_torch.core.hwspec import HopperSpec
from repro_torch.launch import dryrun
from repro_torch.launch.figures import roofline_table
from repro_torch.roofline import analysis
from repro_torch.roofline.trace_analyzer import TraceAnalyzer

torch.set_num_threads(1)

# the TPU v5e's numbers in the port's spec fields (JAX's DEFAULT_TPU)
TPU_AS_SPEC = dataclasses.replace(HopperSpec(), peak_bf16_tflops=197.0,
                                  hbm_gbps=819.0, nvlink_links=4,
                                  nvlink_link_gbps=50.0)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_counts_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert analysis.param_counts(cfg) == janalysis.param_counts(jcfg)
    assert analysis.n_params(cfg) == janalysis.n_params(jcfg)
    assert analysis.n_active_params(cfg) == janalysis.n_active_params(jcfg)
    for shape in jax_shapes_for(jcfg):
        assert analysis.model_flops(cfg, shape.name) == \
            janalysis.model_flops(jcfg, shape.name)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("arch,shape", [("qwen2-0.5b", "train_4k"),
                                        ("deepseek-v3-671b", "decode_32k")])
def test_from_artifact_terms_equal_jax(tmp_path, arch, shape, stats):
    rec = {"arch": arch, "shape": shape, "mesh": "single", "n_devices": 256,
           "flops": 3.5e12, "bytes_accessed": 7.25e9,
           "collective_bytes": {"all-reduce": 1.5e9, "all-gather": 2.5e9}}
    if stats:     # the analyzers' stats, the port's under its own key
        st = {"flops": 5.5e13, "collective_bytes": {"all-gather": 4.0e10,
                                                    "reduce-scatter": 1e9}}
        rec["hlo_stats"] = rec["trace_stats"] = st
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(rec))
    got = analysis.from_artifact(path, spec=TPU_AS_SPEC)
    want = janalysis.from_artifact(path)
    assert (got.compute_ns, got.memory_ns, got.collective_ns) == (
        want.compute_ns, want.memory_ns, want.collective_ns)
    assert (got.flops_dev, got.bytes_dev, got.coll_bytes_dev) == (
        want.hlo_flops_dev, want.hlo_bytes_dev, want.coll_bytes_dev)
    assert got.useful_ratio == want.useful_ratio
    assert got.roofline_frac == want.roofline_frac
    assert got.bound == want.bound and got.row() == want.row()


def test_trace_flops_equal_jax_hlo_analyzer():
    m, k, n, trips = 8, 16, 32, 3
    rng = np.random.default_rng(0)
    x, w1, w2 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((m, k), (k, n), (n, k)))

    def scanned(x, w1, w2):
        def body(c, _):
            return jnp.tanh(c @ w1) @ w2, None
        return jax.lax.scan(body, x, None, length=trips)[0]
    hlo = jax.jit(scanned).lower(x, w1, w2).compile().as_text()
    want = analyze_hlo(hlo).flops
    c, tw1, tw2 = (torch.from_numpy(a) for a in (x, w1, w2))
    with TraceAnalyzer() as mode:
        for _ in range(trips):
            c = torch.tanh(c @ tw1) @ tw2
    assert mode.stats.flops == want == trips * 2 * (2 * m * k * n)


def test_collective_bytes_follow_jax_conventions():
    import torch.distributed._functional_collectives as funcol

    from repro_torch.launch.mesh import local_world
    with local_world("gloo"):
        group = torch.distributed.group.WORLD
        t = torch.ones(4, 8)
        with TraceAnalyzer() as mode:
            funcol.all_reduce(t, "sum", group).wait()
            funcol.all_gather_tensor(t, 0, group).wait()
            funcol.reduce_scatter_tensor(t, "sum", 0, group).wait()
    st = mode.stats
    assert st.collective_bytes == {"all-reduce": 128.0, "all-gather": 128.0,
                                   "reduce-scatter": 128.0}
    assert st.collective_calls == {"all-reduce": 1, "all-gather": 1,
                                   "reduce-scatter": 1}


CELLS = (("qwen2-0.5b", "train_4k"), ("moonshot-v1-16b-a3b", "prefill_32k"),
         ("qwen2-0.5b", "decode_32k"))
JAX_KEYS = ("arch", "shape", "mesh", "n_devices", "mesh_shape", "lower_s",
            "memory", "flops", "bytes_accessed", "collective_bytes")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """One reduced cell of each kind traced on a fake 16 x 16 world, its
    record written to a temp dir."""
    root = tmp_path_factory.mktemp("dryrun_torch")
    out = {}
    for arch, shape in CELLS:
        path = root / f"{arch}__{shape}__single.json"
        out[(arch, shape)] = dryrun.run_cell(
            arch, shape, "single", path, cfg=get_config(arch).reduced())
    return root, out


def _jax_shard_bytes(arch, dtype_bytes, monkeypatch):
    class FakeMesh:
        axis_names = ("data", "model")
        devices = np.empty((16, 16), dtype=object)
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    jt = JaxModel(jax_get_config(arch).reduced()).abstract_ptree()
    specs = jax.tree_util.tree_leaves(
        jshd.param_shardings(jt, FakeMesh()),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(jpm.unwrap(jt)), specs):
        shard = [d // math.prod(16 for _ in (
            () if e is None else (e if isinstance(e, tuple) else (e,))))
            for d, e in zip(leaf.shape, spec)]
        total += math.prod(shard) * dtype_bytes
    return total


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_record_on_a_fake_world(arch, shape, records, monkeypatch):
    _, recs = records
    rec = recs[(arch, shape)]
    assert all(k in rec for k in JAX_KEYS)
    assert rec["n_devices"] == 256
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    mem = rec["memory"]
    assert min(mem["argument_bytes"], mem["output_bytes"],
               mem["temp_bytes"]) > 0
    assert rec["flops"] > 0 and rec["trace_stats"]["flops"] > 0
    assert rec["trace_stats"]["collective_bytes"] == rec["collective_bytes"]
    # reduced configs keep float32 state in training, bf16 elsewhere
    width = 4 if shape == "train_4k" else 2
    assert mem["param_bytes"] == _jax_shard_bytes(arch, width, monkeypatch)


def test_roofline_table_renders_the_records(records):
    root, recs = records
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = roofline_table.main(root)
    text = out.getvalue()
    assert len(rows) == len(recs)
    for r in rows:
        assert r.row() in text
        assert math.isfinite(r.compute_ns) and r.memory_ns > 0


def test_a_failing_cell_fails_the_run(monkeypatch, tmp_path):
    def broken(*args, **kwargs):
        raise RuntimeError("no sharding rule")
    monkeypatch.setattr(dryrun, "run_cell", broken)
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                          "--mesh", "single"])
    assert rc == 1 and "[FAIL]" in out.getvalue()
