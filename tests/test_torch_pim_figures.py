"""The port's figure drivers (``repro_torch.launch.figures``), calibrate,
quickstart, kernel_bench and the offload planner against the JAX
package's ``benchmarks/``, ``scripts/calibrate.py``, ``examples/`` and
``repro.core.planner``, on the CPU.

- Each ``launch.figures.*.run()`` dict equals JAX's ``benchmarks.*.run()``
  dict and emits the same table rows; ``calibrate``'s stdout equals JAX's
  line for line; ``launch.figures.run`` emits every table and raises when
  one fails.
- ``push.evaluate`` on the three paper graphs (400,000 sampled accesses
  each through the LRU model) equals JAX's ``PushResult``.  Three drivers
  and calibrate call it on the same graphs with the same arguments, so
  each package's result is computed once per graph and handed to its
  later callers (:func:`memo`); the drivers' arithmetic around it runs in
  full.
- ``decompose`` equals JAX's for every (arch, shape) of ``shapes_for``
  over the ten configs, in every field but the action text; ``plan``
  equals JAX's with the port's ridge set to JAX's TPU value (read here,
  never in the port), and ``render`` too but for the action lines.
- ``quickstart`` and ``kernel_bench`` with ``--device cpu``: steps 1-2
  print JAX's lines, step 3's plain versions agree with JAX's oracles
  within 1e-5 (float32), kernel_bench's rows hold JAX's rows and its tile
  counts the tiling rule; both raise without a GPU when not told the CPU.
"""
import contextlib
import dataclasses
import io
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:                  # ``benchmarks`` has no
    sys.path.insert(0, str(ROOT))              # __init__: a namespace pkg

import benchmarks.fig6_baseline_pim as j_fig6  # noqa: E402
import benchmarks.fig8_wavesim_opt as j_fig8  # noqa: E402
import benchmarks.fig9_ssgemm_sparsity as j_fig9  # noqa: E402
import benchmarks.fig10_push_cacheaware as j_fig10  # noqa: E402
import benchmarks.headline as j_headline  # noqa: E402
import benchmarks.kernel_bench as j_kernel_bench  # noqa: E402
import benchmarks.limit_studies as j_limit  # noqa: E402
from benchmarks.common import Table as JTable  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shapes_for as j_shapes_for  # noqa: E402
from repro.core import planner as j_planner  # noqa: E402
from repro.core.hwspec import DEFAULT_TPU  # noqa: E402
from repro.core.primitives import push as j_push  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config, shapes_for  # noqa
from repro_torch.core import hwspec, planner  # noqa: E402
from repro_torch.core.primitives import push  # noqa: E402
from repro_torch.launch import calibrate, offload_planner  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch.figures import (  # noqa: E402
    fig6_baseline_pim, fig8_wavesim_opt, fig9_ssgemm_sparsity,
    fig10_push_cacheaware, headline, kernel_bench, limit_studies)
from repro_torch.launch.figures import run as figures_run  # noqa: E402
from repro_torch.launch.figures.common import Table  # noqa: E402

torch.set_num_threads(1)

FIGURES = {"fig6_baseline_pim": (fig6_baseline_pim, j_fig6),
           "fig8_wavesim_opt": (fig8_wavesim_opt, j_fig8),
           "fig9_ssgemm_sparsity": (fig9_ssgemm_sparsity, j_fig9),
           "fig10_push_cacheaware": (fig10_push_cacheaware, j_fig10),
           "headline": (headline, j_headline),
           "limit_studies": (limit_studies, j_limit)}


def memo(real, cache: dict):
    """``evaluate`` computed once per (graph, specs, sample, seed); the
    graph is keyed by its name, sizes, hit rate and a window of its trace,
    so two graphs that differ anywhere get two entries."""
    def evaluate(graph, pim, gpu, *, predictor_sample=400_000, seed=0):
        key = (graph.name, graph.n_nodes, graph.n_edges,
               graph.measured_l2_hit,
               graph.trace_window(16, seed=99).tobytes(), pim, gpu,
               predictor_sample, seed)
        if key not in cache:
            cache[key] = real(graph, pim, gpu,
                              predictor_sample=predictor_sample, seed=seed)
        return cache[key]
    return evaluate


@pytest.fixture(scope="module")
def evaluated():
    """Both packages' ``push.evaluate`` memoised for the module; yields
    (port cache, JAX cache)."""
    caches = ({}, {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(push, "evaluate", memo(push.evaluate, caches[0]))
        mp.setattr(j_push, "evaluate", memo(j_push.evaluate, caches[1]))
        yield caches


@pytest.fixture(scope="module")
def figures(evaluated):
    """Each figure module's (dict, table rows) for both packages, computed
    once: {name: ((port dict, port rows), (JAX dict, JAX rows))}."""
    out = {}
    for name, (mod, jmod) in FIGURES.items():
        t, jt = Table(name), JTable(name)
        got, want = mod.run(t), jmod.run(jt)
        out[name] = ((got, [r.csv() for r in t.rows]),
                     (want, [r.csv() for r in jt.rows]))
    return out


@pytest.mark.parametrize("name", list(FIGURES))
def test_figure_equals_jax(figures, name):
    (got, rows), (want, jrows) = figures[name]
    assert got == want
    assert rows == jrows
    assert got and all(isinstance(v, float) for v in got.values())


def test_paper_push_results_equal_jax(figures, evaluated):
    """The PushResults behind Figures 6 and 10, the headline and the limit
    studies: the three paper graphs at 400,000 samples and the limit
    studies' powerlaw at 120,000."""
    port, jax_ = evaluated
    assert len(port) == len(jax_) == 4

    def by_name(cache):
        return {(k[0], k[7]): dataclasses.asdict(v) for k, v in
                cache.items()}
    assert by_name(port) == by_name(jax_)
    assert {k[0] for k in port} == {"roadnet-usa", "powerlaw-1M-10M",
                                    "powerlaw-10M-100M"}


def test_headline_is_the_models_average(figures):
    """The model's averages, host arithmetic over the studied primitives
    (the paper reports 1.12x and 2.49x)."""
    got = figures["headline"][0][0]
    assert set(got) == {"avg_baseline", "avg_optimized"}
    assert 0.9 < got["avg_baseline"] < 0.91
    assert 1.87 < got["avg_optimized"] < 1.88


def test_run_emits_every_table_and_raises_on_a_failure(figures, capsys,
                                                       monkeypatch):
    got = figures_run.run()
    assert got == {name: figures[name][0][0] for name in FIGURES}
    out = capsys.readouterr().out
    for title, _, _ in figures_run.TABLES:
        assert f"# {title}" in out
    assert figures_run.LEFT_OUT in out
    fast = figures_run.main(["--fast"])
    assert list(fast) == ["fig6_baseline_pim", "fig8_wavesim_opt",
                          "fig9_ssgemm_sparsity"]

    def broken(table=None):
        raise ZeroDivisionError("a table failed")
    monkeypatch.setattr(fig8_wavesim_opt, "run", broken)
    with pytest.raises(ZeroDivisionError):
        figures_run.run(fast=True)


def test_calibrate_prints_jax_lines(evaluated):
    buf, jbuf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf):
        calibrate.main()
    with contextlib.redirect_stdout(jbuf), pytest.raises(SystemExit) as ex:
        runpy.run_path(str(ROOT / "scripts" / "calibrate.py"))
    assert ex.value.code == 0
    assert buf.getvalue().splitlines() == jbuf.getvalue().splitlines()
    assert len(buf.getvalue().splitlines()) == 27


# ---------------------------------------------------------------------------
# the offload planner
# ---------------------------------------------------------------------------

def _cells():
    return [(a, s.name) for a in ALL_ARCHS for s in shapes_for(
        get_config(a))]


def _op_fields(op) -> dict:
    d = dataclasses.asdict(op)
    d.pop("gpu_action", None)
    d.pop("tpu_action", None)
    d["interaction"] = op.interaction.value
    return d


def test_shapes_equal_jax():
    assert len(ALL_ARCHS) == 10
    for arch in ALL_ARCHS:
        got = [dataclasses.astuple(s) for s in shapes_for(get_config(arch))]
        want = [dataclasses.astuple(s) for s in
                j_shapes_for(j_get_config(arch))]
        assert got == want


@pytest.mark.parametrize("arch,shape", _cells())
def test_decompose_and_plan_equal_jax(arch, shape, monkeypatch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sh = next(s for s in shapes_for(cfg) if s.name == shape)
    jsh = next(s for s in j_shapes_for(jcfg) if s.name == shape)
    ops, jops = planner.decompose(cfg, sh), j_planner.decompose(jcfg, jsh)
    assert [_op_fields(o) for o in ops] == [_op_fields(o) for o in jops]
    assert all(o.gpu_action for o in ops)

    monkeypatch.setattr(planner, "RIDGE_OP_BYTE", DEFAULT_TPU.ridge_op_byte)
    got, want = planner.plan(cfg, sh), j_planner.plan(jcfg, jsh)
    assert [(e.op_byte, e.est_pim_speedup, e.report.verdict.value,
             e.report.guidance,
             [dataclasses.astuple(c) for c in e.report.characteristics])
            for e in got] == [
        (e.op_byte, e.est_pim_speedup, e.report.verdict.value,
         e.report.guidance,
         [dataclasses.astuple(c) for c in e.report.characteristics])
        for e in want]
    lines = planner.render(cfg, sh).splitlines()
    jlines = j_planner.render(jcfg, jsh).splitlines()
    assert [ln for ln in lines if "-> GPU action:" not in ln] == \
        [ln for ln in jlines if "-> TPU action:" not in ln]
    assert sum("-> GPU action:" in ln for ln in lines) == len(ops)


def test_planner_reads_the_cards_ridge():
    """The port's ridge is the H100's bf16 peak over its HBM rate; no TPU
    constant is held anywhere in the port."""
    assert planner.RIDGE_OP_BYTE == hwspec.DEFAULT_HOPPER.ridge_op_byte
    assert planner.RIDGE_OP_BYTE == 989.0 * 1e3 / 3350.0
    assert not hasattr(hwspec, "TpuSpec")
    assert not hasattr(hwspec, "DEFAULT_TPU")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert "TpuSpec" not in text and "DEFAULT_TPU" not in text, path


def test_offload_planner_prints_every_cell(capsys):
    offload_planner.main(["--arch", "deepseek-v3-671b"])
    out = capsys.readouterr().out
    cfg = get_config("deepseek-v3-671b")
    for sh in shapes_for(cfg):
        assert planner.render(cfg, sh) in out


# ---------------------------------------------------------------------------
# quickstart and kernel_bench on the CPU
# ---------------------------------------------------------------------------

def test_quickstart_on_cpu_prints_jax_model_lines():
    from repro.kernels.decode_attn.ref import decode_attn_ref
    from repro.kernels.ss_gemm.ref import ssgemm_ref
    from repro.kernels.wavesim_volume.ref import volume_ref
    import jax.numpy as jnp

    buf, jbuf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = quickstart.main(["--device", "cpu"])
    with contextlib.redirect_stdout(jbuf):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                       run_name="__main__")
    lines, jlines = buf.getvalue().splitlines(), jbuf.getvalue().splitlines()
    step3 = lines.index("3) The port's kernels vs their plain versions "
                        "(cpu)")
    assert jlines[step3].startswith("3) ")
    assert lines[:step3] == jlines[:step3]
    assert len(lines) == len(jlines)
    oracles = {"ss-gemm": ssgemm_ref, "wavesim-volume": volume_ref,
               "decode-attn": decode_attn_ref}
    for name, row in res.items():
        assert row["max_abs_err"] <= 1e-5
        args = [jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor)
                else x for x in row["inputs"]]
        want = np.asarray(oracles[name](*args))
        np.testing.assert_allclose(row["out"].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quickstart.main([])


def test_kernel_bench_on_cpu_holds_jax_rows(capsys):
    from repro_torch.kernels.moe_group_gemm import kernel as group_kernel

    j_kernel_bench.main()
    jrows = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("ss-gemm", "moe-group-gemm"))]
    assert len(jrows) == 4
    t = Table("kernel_bench")
    res = kernel_bench.run("cpu", m=192, expert_width=(48, 40), table=t)
    rows = [r.csv() for r in t.rows]
    assert all(r in rows for r in jrows)
    for kind, r in res["ss_gemm"].items():
        b = r["b"].float().numpy()
        live = (b != 0).reshape(-1, kernel_bench.BK, b.shape[1]).any(
            axis=(1, 2)).astype(np.int32)
        np.testing.assert_array_equal(r["occupancy"], live)
        a64, b64 = r["a"].double(), r["b"].double()
        lim = kernel_bench.K * 2.0 ** -24 * (a64.abs() @ b64.abs())
        assert bool(((r["out"].double() - a64 @ b64).abs() <= lim).all())
    assert res["ss_gemm"]["clustered"]["skipped_frac"] > 0.5
    for tokens, r in res["moe"].items():
        counts, cap = r["counts"], r["cap"]
        assert counts.sum() == tokens * 8 and len(counts) == 256
        bm = 16 if cap <= 16 else 256
        n_f = -(-40 // group_kernel.tile_cols(cap, torch.bfloat16))
        total = 256 * -(-cap // bm) * n_f
        live = sum(-(-min(int(c), cap) // bm) for c in counts) * n_f
        assert r["tile_counts"] == (total, total - live)
        assert r["kernel_tiles"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            kernel_bench.main([])
