"""The simulator halves of the port's four primitives
(``repro_torch.core.primitives``: vector-sum, the wave step's volume and
flux, the sparse skinny GEMM, push) against the JAX package's, on the CPU.

Every function of the model is host arithmetic, so every comparison is
``==``: the profiles (and their reports through the port's
``amenability.run_test`` against JAX's), the GPU baselines, the PIM
streams and times, the placements and speedups, ``ss_gemm.speedups`` on
seeded skinny matrices and ``push.evaluate``'s ``PushResult`` (every
field and speedup) on cut-down graphs.  The paper-size graphs go through
``evaluate`` in ``test_torch_pim_figures.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import amenability as j_am
from repro.core.hwspec import GpuSpec as JGpuSpec, PimSpec as JPimSpec
from repro.core.primitives import graphs as j_graphs
from repro.core.primitives import push as j_push
from repro.core.primitives import ss_gemm as j_ss
from repro.core.primitives import vector_sum as j_vs
from repro.core.primitives import wavesim as j_wave
from repro_torch.core import amenability as am
from repro_torch.core.hwspec import GpuSpec, PimSpec
from repro_torch.core.primitives import graphs, push, ss_gemm, vector_sum
from repro_torch.core.primitives import wavesim

torch.set_num_threads(1)


def canon(nodes) -> tuple:
    """A command stream of either package as nested plain tuples."""
    return tuple(("loop", n.trips, canon(n.body)) if hasattr(n, "trips")
                 else ("seg", n.kind.value, n.subset.value, n.count,
                       n.carries_data, n.row_hit_frac) for n in nodes)


def stats(s) -> dict:
    return dict(dataclasses.asdict(s), act_stall_frac=s.act_stall_frac)


# (the port's spec, JAX's spec) pairs: the paper's, the limit studies'
# command bandwidth and registers, and an H100-rate GPU
SPECS = {
    "paper": ({}, {}),
    "cmd-bw 4": ({"command_bw_mult": 4.0}, {}),
    "regs 64": ({"pim_regs_per_alu": 64}, {}),
    "gpu 3350": ({}, {"peak_hbm_gbps": 3350.0}),
}


def specs(name):
    pkw, gkw = SPECS[name]
    return (PimSpec(**pkw), GpuSpec(**gkw)), (JPimSpec(**pkw),
                                              JGpuSpec(**gkw))


def same_profile(got, want) -> None:
    """Equal profiles, and equal amenability reports through each
    package's ``run_test``."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.pop("interaction").value == w.pop("interaction").value
    assert g == w
    assert (got.op_byte, got.mem_ratio) == (want.op_byte, want.mem_ratio)
    for pim_kw in ({}, {"command_bw_mult": 4.0}):
        r = am.run_test(got, PimSpec(**pim_kw), GpuSpec())
        jr = j_am.run_test(want, JPimSpec(**pim_kw), JGpuSpec())
        assert r.verdict.value == jr.verdict.value
        assert [dataclasses.astuple(c) for c in r.characteristics] == \
            [dataclasses.astuple(c) for c in jr.characteristics]
        assert r.guidance == jr.guidance
        assert r.summary() == jr.summary()


def same_time(got, want) -> None:
    assert stats(got) == stats(want)


# ---------------------------------------------------------------------------
# vector-sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("n", [1, 1000, 1 << 20, 64 << 20, 3 * 10**8 + 7])
def test_vector_sum_model_equals_jax(n, spec):
    (pim, gpu), (jpim, jgpu) = specs(spec)
    p, jp = vector_sum.Problem(n), j_vs.Problem(n)
    same_profile(vector_sum.profile(p), j_vs.profile(jp))
    assert vector_sum.gpu_time_ns(p, gpu) == j_vs.gpu_time_ns(jp, jgpu)
    for regs in (None, 8, 16, 32, 64, 128):
        for aa in (False, True):
            kw = dict(arch_aware=aa, regs=regs)
            assert canon(vector_sum.pim_stream(p, pim, **kw)) == canon(
                j_vs.pim_stream(jp, jpim, **kw))
            same_time(vector_sum.pim_time(p, pim, **kw),
                      j_vs.pim_time(jp, jpim, **kw))
            assert vector_sum.speedup(p, pim, gpu, **kw) == \
                j_vs.speedup(jp, jpim, jgpu, **kw)


# ---------------------------------------------------------------------------
# the wave step: volume and flux
# ---------------------------------------------------------------------------

def test_wavesim_constants_equal_jax():
    for name in ("ELEM_BYTES", "NODES_1D", "NODES", "DEFAULT_FIELDS",
                 "VOLUME_PHASE_SHAPE", "VOLUME_WORD_DIV", "FLUX_PHASE_SHAPE",
                 "FLUX_WORD_DIV", "FLUX_SPILL_SHAPE",
                 "FLUX_SPILL_REG_THRESHOLD"):
        assert getattr(wavesim, name) == getattr(j_wave, name), name


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("grid,fields", [((40, 40, 40), 27), ((8, 8, 8), 9),
                                         ((1, 1, 1), 1), ((17, 3, 250), 27),
                                         ((64, 64, 64), 4)])
def test_wavesim_model_equals_jax(grid, fields, spec):
    (pim, gpu), (jpim, jgpu) = specs(spec)
    p, jp = wavesim.Problem(grid, fields), j_wave.Problem(grid, fields)
    for attr in ("n_elements", "points_per_element", "volume_bytes",
                 "face_points", "flux_bytes"):
        assert getattr(p, attr) == getattr(jp, attr)
    same_profile(wavesim.profile_volume(p), j_wave.profile_volume(jp))
    same_profile(wavesim.profile_flux(p), j_wave.profile_flux(jp))
    assert wavesim.gpu_time_volume_ns(p, gpu) == \
        j_wave.gpu_time_volume_ns(jp, jgpu)
    assert wavesim.gpu_time_flux_ns(p, gpu) == \
        j_wave.gpu_time_flux_ns(jp, jgpu)
    assert wavesim._volume_words(p, pim) == j_wave._volume_words(jp, jpim)
    pl, jpl = wavesim.placement(p, pim), j_wave.placement(jp, jpim)
    assert (pl.grid, pl.elems_per_bank, pl.cross_bank_frac) == (
        jpl.grid, jpl.elems_per_bank, jpl.cross_bank_frac)
    for regs in (None, 8, 16, 31, 32, 64, 128):
        for aa in (False, True):
            kw = dict(arch_aware=aa, regs=regs)
            for term in ("volume", "flux"):
                assert canon(getattr(wavesim, f"pim_stream_{term}")(
                    p, pim, **kw)) == canon(getattr(
                        j_wave, f"pim_stream_{term}")(jp, jpim, **kw))
                same_time(getattr(wavesim, f"pim_time_{term}")(p, pim, **kw),
                          getattr(j_wave, f"pim_time_{term}")(jp, jpim,
                                                              **kw))
                assert getattr(wavesim, f"speedup_{term}")(
                    p, pim, gpu, **kw) == getattr(
                        j_wave, f"speedup_{term}")(jp, jpim, jgpu, **kw)


@pytest.mark.parametrize("words,shape,serial", [
    (10**6, (1.5, 1.75, 1.0), 0), (7, (0.75, 0.5, 0.5, 0.5, 0.56, 0.75), 0),
    (123457, (0.75, 0.5, 0.25, 0.25), 2), (0, (1.0,), 1)])
def test_wavesim_stream_helper_equals_jax(words, shape, serial):
    for regs in (2, 16, 33):
        for aa in (False, True):
            assert canon(wavesim._stream(words, shape, PimSpec(), aa, regs,
                                         n_serial=serial)) == canon(
                j_wave._stream(words, shape, JPimSpec(), aa, regs,
                               n_serial=serial))


# ---------------------------------------------------------------------------
# the sparse skinny GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("m,k,n,density", [
    (16384, 4096, 2, 0.55), (16384, 4096, 4, 0.55), (16384, 4096, 8, 0.55),
    (16384, 4096, 16, 0.55), (1000, 300, 3, 0.05), (1, 1, 1, 1.0),
    (70000, 33, 16, 0.9)])
def test_ss_gemm_model_equals_jax(m, k, n, density, spec):
    (pim, gpu), (jpim, jgpu) = specs(spec)
    p = ss_gemm.Problem(m=m, k=k, n=n, density=density)
    jp = j_ss.Problem(m=m, k=k, n=n, density=density)
    same_profile(ss_gemm.profile(p), j_ss.profile(jp))
    for row_zero in (0.0, 0.21, 0.05, 1.0):
        assert ss_gemm.gpu_time_ns(p, gpu, row_zero) == \
            j_ss.gpu_time_ns(jp, jgpu, row_zero)
    for sa in (False, True):
        for dens in (None, 0.0, 0.3, 0.5467, 1.0):
            kw = dict(sparsity_aware=sa, density=dens)
            assert canon(ss_gemm.pim_stream(p, pim, **kw)) == canon(
                j_ss.pim_stream(jp, jpim, **kw))
            same_time(ss_gemm.pim_time(p, pim, **kw),
                      j_ss.pim_time(jp, jpim, **kw))
    for seed in (0, 5):
        assert ss_gemm.speedups(p, pim, gpu, seed=seed) == \
            j_ss.speedups(jp, jpim, jgpu, seed=seed)


# ---------------------------------------------------------------------------
# push
# ---------------------------------------------------------------------------

def test_push_constants_equal_jax():
    for name in ("VALUE_BYTES", "PROP_BYTES", "INDEX_BYTES", "COLD_ROW_HIT",
                 "HOT_ROW_HIT"):
        assert getattr(push, name) == getattr(j_push, name), name


def small_graphs(pkg):
    """Cut-down inputs of both generators (the paper's sizes run through
    the figure drivers)."""
    return [pkg.roadnet(200_000, seed=2),
            pkg.powerlaw(100_000, 1_000_000, alpha=0.6, name="pl-a0.6",
                         measured_l2_hit=0.2),
            pkg.powerlaw(300_000, 3_000_000, alpha=1.02, name="pl-a1.02",
                         measured_l2_hit=0.57, seed=1),
            pkg.powerlaw(5_000, 20_000, alpha=1.0, name="pl-a1",
                         measured_l2_hit=0.0, seed=3)]


@pytest.mark.parametrize("gi", range(4))
@pytest.mark.parametrize("spec", list(SPECS))
def test_push_model_equals_jax(gi, spec):
    (pim, gpu), (jpim, jgpu) = specs(spec)
    g, jg = small_graphs(graphs)[gi], small_graphs(j_graphs)[gi]
    same_profile(push.profile(g), j_push.profile(jg))
    for hit in (None, 0.0, 0.42, 1.0):
        for ca in (False, True):
            assert push.gpu_time_ns(g, gpu, hit_rate=hit, cache_aware=ca) \
                == j_push.gpu_time_ns(jg, jgpu, hit_rate=hit, cache_aware=ca)
    for upd in (None, 0, 1, 31, 12345, g.n_edges * 3):
        assert push.gpu_feed_time_ns(g, gpu, upd) == \
            j_push.gpu_feed_time_ns(jg, jgpu, upd)
        for row_hit in (push.HOT_ROW_HIT, push.COLD_ROW_HIT, 0.0):
            kw = dict(n_updates=upd, row_hit_frac=row_hit)
            assert canon(push.pim_stream(g, pim, **kw)) == canon(
                j_push.pim_stream(jg, jpim, **kw))
            same_time(push.pim_time(g, pim, **kw),
                      j_push.pim_time(jg, jpim, **kw))


@pytest.mark.parametrize("gi", range(4))
@pytest.mark.parametrize("sample,seed", [(20_000, 0), (7_777, 4)])
def test_push_evaluate_equals_jax(gi, sample, seed):
    """The §5.2.3 comparison: the LRU predictor's hit rate on a sampled
    window, then every time and speedup, at two samples and seeds."""
    g, jg = small_graphs(graphs)[gi], small_graphs(j_graphs)[gi]
    got = push.evaluate(g, PimSpec(), GpuSpec(), predictor_sample=sample,
                        seed=seed)
    want = j_push.evaluate(jg, JPimSpec(), JGpuSpec(),
                           predictor_sample=sample, seed=seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.speedup_baseline, got.speedup_cache_aware,
            got.speedup_gpu_cache_aware) == (
        want.speedup_baseline, want.speedup_cache_aware,
        want.speedup_gpu_cache_aware)


def test_paper_profiles_equal_jax():
    """The profiles quickstart and the figures run, on the paper inputs."""
    for g, jg in zip(graphs.paper_inputs(), j_graphs.paper_inputs()):
        same_profile(push.profile(g), j_push.profile(jg))
    same_profile(vector_sum.profile(vector_sum.Problem(64 << 20)),
                 j_vs.profile(j_vs.Problem(64 << 20)))
    same_profile(wavesim.profile_volume(wavesim.Problem()),
                 j_wave.profile_volume(j_wave.Problem()))
    same_profile(ss_gemm.profile(ss_gemm.Problem(n=4)),
                 j_ss.profile(j_ss.Problem(n=4)))
    b = ss_gemm.make_skinny(ss_gemm.Problem(), 0)
    np.testing.assert_array_equal(b, j_ss.make_skinny(j_ss.Problem(), 0))
