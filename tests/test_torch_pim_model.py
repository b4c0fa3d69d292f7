"""The port's PIM model (``repro_torch.core``: commands, timing,
optimizations, placement, the GPU and cache models, the functional PIM
machine) against the JAX package's ``repro.core``, on the CPU.

All of it is host arithmetic in Python floats and numpy, so every
comparison is ``==``: a difference means the copy is wrong.
- ``simulate`` and every ``TimingStats`` field on every stream the four
  primitives generate at every figure setting, and on seeded random
  ``Seg``/``Loop`` streams (nested loops, every command kind);
- the cases of JAX's ``test_timing_model.py`` and
  ``test_functional_sim.py``, and the schedule, ``sparsity_thin``,
  ``cache_split``, LRU and loop-compression properties of
  ``test_properties.py`` (on seeded draws in place of hypothesis), run
  against the port as parametrised cases;
- ``PimMachine`` programs give JAX's rows, registers and open rows on
  seeded arrays; ``LruCache`` and ``sampled_hit_rate`` give JAX's hit
  masks and final state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cache_model as j_cache
from repro.core import commands as j_cmd
from repro.core import functional_sim as j_fsim
from repro.core import gpu_model as j_gpu
from repro.core import optimizations as j_opt
from repro.core import placement as j_place
from repro.core import timing as j_timing
from repro.core.hwspec import GpuSpec as JGpuSpec, PimSpec as JPimSpec
from repro.core.primitives import push as j_push
from repro.core.primitives import ss_gemm as j_ss
from repro.core.primitives import vector_sum as j_vs
from repro.core.primitives import wavesim as j_wave
from repro.core.primitives.graphs import paper_inputs as j_paper_inputs
from repro_torch.core import cache_model, commands, functional_sim
from repro_torch.core import gpu_model, optimizations, placement, timing
from repro_torch.core.commands import Kind, Loop, Seg, Subset
from repro_torch.core.hwspec import GpuSpec, PimSpec
from repro_torch.core.primitives import push, ss_gemm, vector_sum, wavesim
from repro_torch.core.primitives.graphs import paper_inputs

torch.set_num_threads(1)

PIM = PimSpec()
SPECS = {"default": {}, "cmd-bw 4": {"command_bw_mult": 4.0},
         "cmd-bw 2, 64 regs": {"command_bw_mult": 2.0,
                               "pim_regs_per_alu": 64}}


def canon(nodes) -> tuple:
    """A stream of either package as nested plain tuples."""
    out = []
    for n in nodes:
        if hasattr(n, "trips"):
            out.append(("loop", n.trips, canon(n.body)))
        else:
            out.append(("seg", n.kind.value, n.subset.value, n.count,
                        n.carries_data, n.row_hit_frac))
    return tuple(out)


def build(desc, pkg) -> list:
    """A stream of ``pkg`` (the port's or JAX's ``commands``) from
    :func:`canon`'s form."""
    out = []
    for d in desc:
        if d[0] == "loop":
            out.append(pkg.Loop(tuple(build(d[2], pkg)), d[1]))
        else:
            out.append(pkg.Seg(pkg.Kind(d[1]), pkg.Subset(d[2]), d[3],
                               carries_data=d[4], row_hit_frac=d[5]))
    return out


def stats(s) -> dict:
    return dict(dataclasses.asdict(s), act_stall_frac=s.act_stall_frac)


def assert_same_timing(got_stream, want_stream, spec_kw) -> None:
    assert canon(got_stream) == canon(want_stream)
    got = timing.simulate(got_stream, PimSpec(**spec_kw))
    want = j_timing.simulate(want_stream, JPimSpec(**spec_kw))
    assert stats(got) == stats(want)
    assert commands.total_commands(got_stream) == \
        j_cmd.total_commands(want_stream)
    assert {k.value: v for k, v in
            commands.total_by_kind(got_stream).items()} == \
        {k.value: v for k, v in j_cmd.total_by_kind(want_stream).items()}


# ---------------------------------------------------------------------------
# every stream the four primitives generate at every figure setting
# ---------------------------------------------------------------------------

REGS = (None, 8, 16, 32, 64, 128)     # Figure 8's and the limit studies'


def _primitive_streams():
    cases = []
    for regs in REGS:
        for aa in (False, True):
            tag = f"regs{regs}-{'aa' if aa else 'base'}"
            cases.append((f"vector-sum-{tag}", "vector_sum", "pim_stream",
                          ("vs",), dict(arch_aware=aa, regs=regs)))
            for fn in ("pim_stream_volume", "pim_stream_flux"):
                cases.append((f"{fn}-{tag}", "wavesim", fn, ("wave",),
                              dict(arch_aware=aa, regs=regs)))
    for n in (2, 4, 8, 16):
        cases.append((f"ss-gemm-N{n}", "ss_gemm", "pim_stream", ("ss", n),
                      {}))
        # the sparsity-aware stream at the density speedups() measures
        cases.append((f"ss-gemm-N{n}-sa", "ss_gemm", "pim_stream",
                      ("ss", n), dict(sparsity_aware=True, density="meas")))
    for gi in range(3):
        for upd, hit in ((None, "hot"), (0.58, "cold"), (0.79, "cold"),
                         (0.37, "cold")):
            cases.append((f"push-g{gi}-{upd}-{hit}", "push", "pim_stream",
                          ("graph", gi), dict(n_updates=upd, row_hit=hit)))
    return cases


_PORT_MODS = {"vector_sum": vector_sum, "wavesim": wavesim,
              "ss_gemm": ss_gemm, "push": push}
_JAX_MODS = {"vector_sum": j_vs, "wavesim": j_wave, "ss_gemm": j_ss,
             "push": j_push}


def _args(pkg_mods, problem, kw, graphs):
    mod = pkg_mods
    kw = dict(kw)
    if problem[0] == "vs":
        return (mod["vector_sum"].Problem(n=64 << 20),), kw
    if problem[0] == "wave":
        return (mod["wavesim"].Problem(),), kw
    if problem[0] == "ss":
        p = mod["ss_gemm"].Problem(n=problem[1])
        if kw.get("density") == "meas":
            kw["density"] = mod["ss_gemm"].measured_sparsity(
                mod["ss_gemm"].make_skinny(p, 0))[0]
        return (p,), kw
    g = graphs[problem[1]]
    frac = kw.pop("n_updates")
    kw["n_updates"] = None if frac is None else max(1, int(g.n_edges * frac))
    hit = kw.pop("row_hit")
    kw["row_hit_frac"] = (mod["push"].HOT_ROW_HIT if hit == "hot"
                          else mod["push"].COLD_ROW_HIT)
    return (g,), kw


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("case", _primitive_streams(), ids=lambda c: c[0])
def test_primitive_streams_simulate_as_jax(case, spec):
    _, mod, fn, problem, kw = case
    pa, pkw = _args(_PORT_MODS, problem, kw, paper_inputs())
    ja, jkw = _args(_JAX_MODS, problem, kw, j_paper_inputs())
    got = getattr(_PORT_MODS[mod], fn)(*pa, PimSpec(**SPECS[spec]), **pkw)
    want = getattr(_JAX_MODS[mod], fn)(*ja, JPimSpec(**SPECS[spec]), **jkw)
    assert_same_timing(got, want, SPECS[spec])


# ---------------------------------------------------------------------------
# seeded random streams
# ---------------------------------------------------------------------------

def random_stream(rng: np.random.Generator, depth: int = 0) -> tuple:
    out = []
    for _ in range(int(rng.integers(1, 6))):
        r = rng.random()
        if r < 0.2 and depth < 3:
            out.append(("loop", int(rng.choice([0, 1, 2, 3, 7, 50, 1000,
                                                123457])),
                        random_stream(rng, depth + 1)))
        elif r < 0.4:
            out.append(("seg", "act", str(rng.choice(["even", "odd", "all"])),
                        int(rng.integers(0, 4)), True, 0.0))
        elif r < 0.7:
            out.append(("seg", "pim_bcast", str(rng.choice(["even", "odd"])),
                        int(rng.integers(0, 40)), True, 0.0))
        elif r < 0.9:
            out.append(("seg", "pim_sb", "all", int(rng.integers(0, 5000)),
                        bool(rng.random() < 0.5),
                        float(rng.choice([0.0, 0.3, 0.85, 1.0,
                                          rng.random()]))))
        else:
            out.append(("seg", str(rng.choice(["rd", "wr"])), "all",
                        int(rng.integers(0, 20)), True, 0.0))
    return tuple(out)


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("seed", range(24))
def test_random_streams_simulate_as_jax(seed, spec):
    desc = random_stream(np.random.default_rng(seed))
    got, want = build(desc, commands), build(desc, j_cmd)
    assert_same_timing(got, want, SPECS[spec])
    if commands.total_commands(got) <= 20_000:
        assert canon(commands.flatten(got)) == canon(j_cmd.flatten(want))


def test_stream_validation_as_jax():
    for pkg in (commands, j_cmd):
        with pytest.raises(ValueError):
            pkg.Seg(pkg.Kind.PIM_BCAST, pkg.Subset.ALL)
        with pytest.raises(ValueError):
            pkg.Seg(pkg.Kind.ACT, count=-1)
        with pytest.raises(ValueError):
            pkg.Loop((), -1)
        big = [pkg.Loop((pkg.Seg(pkg.Kind.RD, count=1000),), 3000)]
        with pytest.raises(ValueError):
            pkg.flatten(big)
    assert [k.value for k in Kind] == [k.value for k in j_cmd.Kind]
    assert [s.value for s in Subset] == [s.value for s in j_cmd.Subset]
    assert timing.PimTimer.MAX_WARMUP == j_timing.PimTimer.MAX_WARMUP


# ---------------------------------------------------------------------------
# JAX's test_timing_model.py, against the port
# ---------------------------------------------------------------------------

def _spec_identities():
    assert abs(PIM.regular_bytes_per_ns_per_pch * PIM.pch_per_stack
               - 614.4) < 1e-6
    assert abs(PIM.pim_peak_gbps - 4 * 614.4) < 1e-6
    assert PIM.cols_per_row == 32
    assert PIM.banks_per_subset == 8


def _command_counting():
    stream = [Loop((Seg(Kind.ACT, Subset.ALL),
                    Seg(Kind.PIM_BCAST, Subset.EVEN, 8),
                    Seg(Kind.PIM_BCAST, Subset.ODD, 8)), 10)]
    assert commands.total_commands(stream) == 170
    by = commands.total_by_kind(stream)
    assert by[Kind.ACT] == 10 and by[Kind.PIM_BCAST] == 160


def _bcast_issue_rate():
    st = timing.simulate([Seg(Kind.PIM_BCAST, Subset.EVEN, 100)], PIM)
    assert st.time_ns == pytest.approx(100 * PIM.t_ccdl_ns, rel=1e-6)


def _activation_blocks_compute():
    st = timing.simulate([Seg(Kind.ACT, Subset.EVEN),
                          Seg(Kind.PIM_BCAST, Subset.EVEN, 1)], PIM)
    assert st.time_ns >= PIM.row_switch_ns
    assert st.act_stall_ns > 0


def _opposite_subset_not_blocked():
    st = timing.simulate([Seg(Kind.ACT, Subset.EVEN),
                          Seg(Kind.PIM_BCAST, Subset.ODD, 20)], PIM)
    assert st.act_stall_ns == 0.0


def _arch_aware_beats_baseline():
    phases = [optimizations.Phase(8)] * 3
    base = timing.simulate(optimizations.baseline_schedule(phases, 200), PIM)
    opt = timing.simulate(optimizations.arch_aware_schedule(phases, 200),
                          PIM)
    assert opt.time_ns < base.time_ns
    assert opt.act_stall_frac < base.act_stall_frac


def _arch_aware_gain_needs_commands_per_phase():
    def gain(phases, trips):
        return (timing.simulate(optimizations.baseline_schedule(
            phases, trips), PIM).time_ns
            / timing.simulate(optimizations.arch_aware_schedule(
                phases, trips), PIM).time_ns)
    assert gain([optimizations.Phase(24)] * 6, 500) > \
        gain([optimizations.Phase(2)] * 6, 500)


def _loop_steady_state_matches_unrolled():
    body = (Seg(Kind.ACT, Subset.ALL), Seg(Kind.PIM_BCAST, Subset.EVEN, 8),
            Seg(Kind.PIM_BCAST, Subset.ODD, 8))
    looped = timing.simulate([Loop(body, 50)], PIM)
    unrolled = timing.simulate(list(body) * 50, PIM)
    assert looped.time_ns == pytest.approx(unrolled.time_ns, rel=1e-9)
    assert looped.n_cmds == unrolled.n_cmds


def _single_bank_command_bus_bound():
    segs = [Seg(Kind.PIM_SB, Subset.ALL, 1000, carries_data=True,
                row_hit_frac=0.9),
            Seg(Kind.PIM_SB, Subset.ALL, 1000, carries_data=False,
                row_hit_frac=1.0)]
    st = timing.simulate(segs, PIM)
    assert st.time_ns == pytest.approx(2000 * PIM.t_ccds_ns, rel=1e-6)
    st4 = timing.simulate(segs, PimSpec(command_bw_mult=4.0))
    assert st4.time_ns == pytest.approx(1000 * PIM.t_ccds_ns, rel=1e-6)
    assert st4.time_ns < st.time_ns


def _single_bank_activation_bound():
    seg = [Seg(Kind.PIM_SB, Subset.ALL, 1000, carries_data=True,
               row_hit_frac=0.0)]
    st = timing.simulate(seg, PimSpec(command_bw_mult=4.0))
    expect = 1000 * PIM.row_cycle_ns / PIM.banks_per_pch
    assert st.time_ns == pytest.approx(expect, rel=1e-6)


TIMING_CASES = {f.__name__[1:]: f for f in (
    _spec_identities, _command_counting, _bcast_issue_rate,
    _activation_blocks_compute, _opposite_subset_not_blocked,
    _arch_aware_beats_baseline, _arch_aware_gain_needs_commands_per_phase,
    _loop_steady_state_matches_unrolled, _single_bank_command_bus_bound,
    _single_bank_activation_bound)}


@pytest.mark.parametrize("case", list(TIMING_CASES))
def test_timing_model_case(case):
    TIMING_CASES[case]()


# ---------------------------------------------------------------------------
# JAX's test_properties.py (the model's properties), on seeded draws
# ---------------------------------------------------------------------------

def _draws(seed: int, **ranges) -> dict:
    rng = np.random.default_rng(seed)
    return {k: int(rng.integers(lo, hi + 1)) for k, (lo, hi) in
            ranges.items()}


@pytest.mark.parametrize("seed", range(8))
def test_arch_aware_never_slower(seed):
    d = _draws(seed, cmds=(1, 64), trips=(1, 200), phases=(1, 6))
    ph = [optimizations.Phase(d["cmds"])] * d["phases"]
    base = optimizations.baseline_schedule(ph, d["trips"])
    opt = optimizations.arch_aware_schedule(ph, d["trips"])
    assert timing.simulate(opt, PIM).time_ns <= \
        timing.simulate(base, PIM).time_ns * 1.02
    jph = [j_opt.Phase(d["cmds"])] * d["phases"]
    assert canon(base) == canon(j_opt.baseline_schedule(jph, d["trips"]))
    assert canon(opt) == canon(j_opt.arch_aware_schedule(jph, d["trips"]))


@pytest.mark.parametrize("seed", range(8))
def test_schedules_equal_compute_commands(seed):
    d = _draws(seed + 100, cmds=(1, 40), trips=(1, 100), phases=(1, 5))
    ph = [optimizations.Phase(d["cmds"])] * d["phases"]
    b = commands.total_by_kind(optimizations.baseline_schedule(ph, d["trips"]))
    o = commands.total_by_kind(optimizations.arch_aware_schedule(ph,
                                                                 d["trips"]))
    assert b[Kind.PIM_BCAST] == o[Kind.PIM_BCAST]


def test_sparsity_thin_and_cache_split_as_jax():
    rng = np.random.default_rng(7)
    grid = [(int(c), float(x)) for c, x in
            zip(rng.integers(0, 10_000, 200), rng.random(200))]
    grid += [(c, x) for c in (0, 1, 31, 32, 4096) for x in
             (0.0, 0.5, 0.55, 1.0)]
    for cmds, density in grid:
        out = optimizations.sparsity_thin(cmds, density)
        assert out == j_opt.sparsity_thin(cmds, density)
        assert 0 <= out <= cmds
        if density == 1.0:
            assert out == cmds
        s, js = (optimizations.cache_split(cmds, density),
                 j_opt.cache_split(cmds, density))
        assert (s.hot, s.cold, s.total, s.hot_frac) == (
            js.hot, js.cold, js.total, js.hot_frac)
        assert s.hot + s.cold == cmds and 0 <= s.hot <= cmds
    for bad in (-0.1, 1.5):
        for mod in (optimizations, j_opt):
            with pytest.raises(ValueError):
                mod.sparsity_thin(10, bad)


@pytest.mark.parametrize("seed", range(6))
def test_lru_hit_rate_bounds_and_repeat_hits(seed):
    d = _draws(seed + 200, trace=(0, 1000), length=(1, 400))
    addrs = np.random.default_rng(d["trace"]).integers(
        0, 1 << 20, size=d["length"]) * 64
    c = cache_model.LruCache(capacity_bytes=64 * 1024, ways=4)
    jc = j_cache.LruCache(capacity_bytes=64 * 1024, ways=4)
    r1, j1 = c.run_trace(addrs), jc.run_trace(addrs)
    assert 0 <= r1.hit_rate <= 1
    np.testing.assert_array_equal(r1.hit_mask, j1.hit_mask)
    r2 = c.run_trace(addrs[-8:])
    assert r2.hit_rate == 1.0 == jc.run_trace(addrs[-8:]).hit_rate


@pytest.mark.parametrize("seed", range(8))
def test_loop_compression_exact(seed):
    d = _draws(seed + 300, body=(0, 100), trips=(1, 30), cmds=(1, 30))
    rng = np.random.default_rng(d["body"])
    body = []
    for _ in range(rng.integers(1, 5)):
        if rng.random() < 0.4:
            body.append(Seg(Kind.ACT, Subset.ALL))
        else:
            sub = Subset.EVEN if rng.random() < 0.5 else Subset.ODD
            body.append(Seg(Kind.PIM_BCAST, sub, d["cmds"]))
    looped = timing.simulate([Loop(tuple(body), d["trips"])], PIM)
    unrolled = timing.simulate(body * d["trips"], PIM)
    assert abs(looped.time_ns - unrolled.time_ns) < 1e-6 * max(
        1.0, unrolled.time_ns)
    want = j_timing.simulate(build(canon([Loop(tuple(body), d["trips"])]),
                                   j_cmd), JPimSpec())
    assert stats(looped) == stats(want)


# ---------------------------------------------------------------------------
# the cache model, placement and the GPU model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "zipf", "stride", "graph"])
def test_lru_cache_state_as_jax(kind):
    """Hit masks and the final tags and stamps, over two traces in a row
    (state carries), at the default 4 MiB 16-way geometry and a small
    one."""
    rng = np.random.default_rng(11)
    n = 30_000
    if kind == "uniform":
        addrs = rng.integers(0, 1 << 26, n) * 32
    elif kind == "zipf":
        addrs = np.minimum(rng.zipf(1.3, n), 1 << 22) * 32
    elif kind == "stride":
        addrs = (np.arange(n) * 4096) % (1 << 24)
    else:
        addrs = paper_inputs()[0].trace_window(n, seed=3).astype(np.int64) \
            * push.PROP_BYTES
    for kw in ({}, {"capacity_bytes": 32 * 1024, "ways": 2,
                    "line_bytes": 32}):
        c, jc = cache_model.LruCache(**kw), j_cache.LruCache(**kw)
        for part in (addrs[: n // 3], addrs[n // 3:]):
            got, want = c.run_trace(part), jc.run_trace(part)
            np.testing.assert_array_equal(got.hit_mask, want.hit_mask)
            assert (got.hits, got.misses, got.hit_rate) == (
                want.hits, want.misses, want.hit_rate)
        np.testing.assert_array_equal(c.tags, jc.tags)
        np.testing.assert_array_equal(c.lru, jc.lru)
    for mod in (cache_model, j_cache):
        with pytest.raises(ValueError):
            mod.LruCache(capacity_bytes=3 * 64 * 16)


@pytest.mark.parametrize("sample,seed", [(5_000, 0), (5_000, 9),
                                         (20_000, 1), (100_000, 0)])
def test_sampled_hit_rate_as_jax(sample, seed):
    """The window's start (drawn from ``seed`` when the trace is longer
    than ``sample``) and the 10% warm-up, on a trace longer and one shorter
    than the sample, with the paper GPU's spec and a small cache."""
    g = paper_inputs()[1]
    addrs = g.trace_window(60_000, seed=seed).astype(np.int64) * 32
    for kw in ({"spec": GpuSpec()}, {"capacity_bytes": 64 * 1024,
                                      "ways": 4}):
        jkw = {k: (JGpuSpec() if k == "spec" else v) for k, v in kw.items()}
        got = cache_model.sampled_hit_rate(addrs, sample=sample, seed=seed,
                                           **kw)
        want = j_cache.sampled_hit_rate(addrs, sample=sample, seed=seed,
                                        **jkw)
        np.testing.assert_array_equal(got.hit_mask, want.hit_mask)
        assert got.hit_rate == want.hit_rate


def test_placement_and_gpu_model_as_jax():
    jpim = JPimSpec()
    for spec_kw in ({}, {"row_buffer_bytes": 2048}):
        sp, jsp = PimSpec(**spec_kw), JPimSpec(**spec_kw)
        for n in (1, 31, 32 * 1024, 3 * 2**20 + 7, 64 << 21):
            for structures in (1, 3):
                got = placement.CoAligned(n, structures, sp)
                want = j_place.CoAligned(n, structures, jsp)
                assert (got.bytes_per_pch, got.rows_per_bank,
                        got.words_per_bank) == (want.bytes_per_pch,
                                                want.rows_per_bank,
                                                want.words_per_bank)
        for m, k in ((1, 1), (16384, 4096), (1000, 300), (3, 70000)):
            got = placement.BlockedMatrix(m, k, sp)
            want = j_place.BlockedMatrix(m, k, jsp)
            assert (got.m_per_bank, got.k_words_per_row,
                    got.rows_per_mblock, got.mblocks_per_bank) == (
                want.m_per_bank, want.k_words_per_row,
                want.rows_per_mblock, want.mblocks_per_bank)
    for grid in ((1, 1, 1), (8, 8, 8), (40, 40, 40), (17, 3, 250)):
        got = placement.grid_placement(grid, PIM)
        want = j_place.grid_placement(grid, jpim)
        assert (got.grid, got.elems_per_bank, got.n_elements,
                got.cross_bank_frac) == (want.grid, want.elems_per_bank,
                                         want.n_elements,
                                         want.cross_bank_frac)
    for gkw in ({}, {"peak_hbm_gbps": 3350.0}, {"bw_efficiency": 0.5}):
        g, jg = GpuSpec(**gkw), JGpuSpec(**gkw)
        for nbytes in (0.0, 1.0, 402653184.0, 7.3e12):
            assert gpu_model.time_ns(nbytes, g) == j_gpu.time_ns(nbytes, jg)
            got = gpu_model.estimate(nbytes, g, note="x")
            want = j_gpu.estimate(nbytes, jg, note="x")
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
        for acc, hit, line in ((10**6, 0.42, 64), (57_600_000, 0.0, 32),
                               (3, 1.0, 64)):
            assert gpu_model.cached_traffic(acc, hit, line) == \
                j_gpu.cached_traffic(acc, hit, line)


@pytest.mark.parametrize("regs", [1, 2, 7, 16, 33, 64, 128])
def test_schedules_and_chunks_as_jax(regs):
    assert optimizations.chunk_cols(regs) == j_opt.chunk_cols(regs)
    shapes = [(5, False), (0, False), (3, True), (9, False), (1, True)]
    ph = [optimizations.Phase(c, serial=s) for c, s in shapes]
    jph = [j_opt.Phase(c, serial=s) for c, s in shapes]
    for aa in (False, True):
        got = optimizations.schedule(ph, regs, aa)
        want = j_opt.schedule(jph, regs, aa)
        assert canon(got) == canon(want)
        assert stats(timing.simulate(got, PIM)) == stats(
            j_timing.simulate(want, JPimSpec()))


# ---------------------------------------------------------------------------
# the functional PIM machine: JAX's test_functional_sim.py, and JAX's rows
# ---------------------------------------------------------------------------

def _fsim_vector_sum():
    spec = PimSpec()
    m = functional_sim.PimMachine(spec)
    rng = np.random.default_rng(0)
    n = 5000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    functional_sim.place_coaligned(m, {0: a, 1: b,
                                       2: np.zeros(n, np.float32)})
    m.execute(functional_sim.elementwise_program(
        spec, in_rows=[0, 1], out_row=2, fn=lambda r, x: r + x))
    np.testing.assert_allclose(functional_sim.gather_coaligned(m, 2, n),
                               a + b, rtol=1e-6)


def _fsim_three_operand_fma():
    spec = PimSpec()
    m = functional_sim.PimMachine(spec)
    rng = np.random.default_rng(1)
    n = 2048
    a, b, d = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    functional_sim.place_coaligned(m, {0: a, 1: b, 2: d,
                                       3: np.zeros(n, np.float32)})
    prog = functional_sim.elementwise_program(spec, in_rows=[0, 1],
                                              out_row=3,
                                              fn=lambda r, x: r + x)
    prog += functional_sim.elementwise_program(spec, in_rows=[3, 2],
                                               out_row=3,
                                               fn=lambda r, x: r * x)
    m.execute(prog)
    np.testing.assert_allclose(functional_sim.gather_coaligned(m, 3, n),
                               (a + b) * d, rtol=1e-5)


def _fsim_register_bounds():
    m = functional_sim.PimMachine()
    m.write_row(0, 0, np.zeros((32, 16), np.float32))
    with pytest.raises(ValueError):
        m.execute([functional_sim.Cmd("act", "all", row=0),
                   functional_sim.Cmd("ld", "even", col=0, reg=99)])


def _fsim_requires_open_row():
    m = functional_sim.PimMachine()
    with pytest.raises(RuntimeError):
        m.execute([functional_sim.Cmd("ld", "even", col=0, reg=0)])


def _fsim_command_mix_matches_timing_model():
    spec = PimSpec()
    prog = functional_sim.elementwise_program(spec, in_rows=[0, 1],
                                              out_row=2,
                                              fn=lambda r, x: r + x)
    n_act = sum(1 for c in prog if c.kind == "act")
    n_compute = sum(1 for c in prog if c.kind != "act")
    cols = optimizations.chunk_cols(spec.pim_regs_per_alu)
    stream = optimizations.baseline_schedule(
        [optimizations.Phase(cols)] * 3, spec.cols_per_row // cols)
    by = commands.total_by_kind(stream)
    assert by[Kind.ACT] == n_act
    assert by[Kind.PIM_BCAST] == n_compute


FSIM_CASES = {f.__name__[1:]: f for f in (
    _fsim_vector_sum, _fsim_three_operand_fma, _fsim_register_bounds,
    _fsim_requires_open_row, _fsim_command_mix_matches_timing_model)}


@pytest.mark.parametrize("case", list(FSIM_CASES))
def test_functional_sim_case(case):
    FSIM_CASES[case]()


def _machine_state(m) -> tuple:
    return (sorted(m.mem), [m.mem[r] for r in sorted(m.mem)], m.regs,
            m.open_row)


FNS = {"add": lambda r, x: r + x, "mul": lambda r, x: r * x,
       "sub": lambda r, x: r - x, "max": np.maximum}


@pytest.mark.parametrize("regs", [4, 16, 64])
@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("n_in", [1, 2, 3])
def test_machine_programs_give_jax_rows(n_in, fn, regs):
    """Programs of 1-3 input rows (a ld, then op phases) and a chained
    second program, on seeded arrays that fill a row-set partly, run on
    both machines: equal command lists, DRAM rows, registers and open
    rows."""
    sp, jsp = PimSpec(pim_regs_per_alu=regs), JPimSpec(pim_regs_per_alu=regs)
    rng = np.random.default_rng(n_in * 100 + regs)
    n = int(rng.integers(1, 16 * 32 * 16 + 1))
    arrays = {r: rng.standard_normal(n).astype(np.float32)
              for r in range(n_in)}
    arrays[7] = np.zeros(n, np.float32)
    m, jm = functional_sim.PimMachine(sp), j_fsim.PimMachine(jsp)
    functional_sim.place_coaligned(m, arrays)
    j_fsim.place_coaligned(jm, arrays)
    rows = list(range(n_in))
    prog = functional_sim.elementwise_program(sp, rows, 7, FNS[fn])
    prog += functional_sim.elementwise_program(sp, [7, 0], 5, FNS["add"])
    jprog = j_fsim.elementwise_program(jsp, rows, 7, FNS[fn])
    jprog += j_fsim.elementwise_program(jsp, [7, 0], 5, FNS["add"])
    assert [dataclasses.astuple(c) for c in prog] == \
        [dataclasses.astuple(c) for c in jprog]
    m.execute(prog)
    jm.execute(jprog)
    got, want = _machine_state(m), _machine_state(jm)
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    for row in (5, 7):
        np.testing.assert_array_equal(
            functional_sim.gather_coaligned(m, row, n),
            j_fsim.gather_coaligned(jm, row, n))


def test_machine_refusals_as_jax():
    for mod in (functional_sim, j_fsim):
        m = mod.PimMachine()
        with pytest.raises(ValueError):
            mod.place_coaligned(m, {0: np.zeros(16 * 32 * 16 + 1)})
        m.execute([mod.Cmd("act", "odd", row=3)])
        with pytest.raises(ValueError):
            m.execute([mod.Cmd("ld", "all", col=0, reg=0)])
        with pytest.raises(ValueError):
            m.execute([mod.Cmd("nop", "odd", col=0, reg=0)])
        with pytest.raises(RuntimeError):
            m.execute([mod.Cmd("st", "even", col=0, reg=0)])
        assert list(m.open_row) == [-1, 3] * 8
