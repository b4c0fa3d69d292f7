"""The port's batcher policies and accounting against the JAX ``Batcher``
on the same float32 weights at qwen2-0.5b ``reduced()``: skip-ahead
admission (the five cases of ``tests/test_scheduler.py``, each run
through both batchers, with equal admit orders, tokens and
``kv_utilization()``), ``kv_utilization`` over synthetic samples, the
metrics registry against JAX's on the same observations,
``latency_stats`` and ``join_stats`` with JAX's keys, ``reset_stats``
and a warm second wave, the slot state written in place (the same
tensors across joins and segments, which a captured decode graph
needs), the launch tally of :mod:`repro_torch.kernels.launches`, and
``graphs=True`` refused on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Batcher as JaxBatcher
from repro.serve.scheduler import ContinuousBatcher as JaxContinuousBatcher
from repro.serve.telemetry import MetricsRegistry as JaxMetricsRegistry
from repro_torch.configs import get_config
from repro_torch.kernels import launches
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Batcher, ContinuousBatcher
from repro_torch.serve.telemetry import MetricsRegistry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-0.5b").reduced()
    jmodel = JaxModel(jax_get_config("qwen2-0.5b").reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), tparams


def _pair(setup, **kw):
    """The JAX and the port batcher on one configuration (float32)."""
    _, jmodel, jparams, model, tparams = setup
    jb = JaxBatcher(jmodel, jparams, JaxServeConfig(dtype=jnp.float32, **kw))
    tb = Batcher(model, tparams, ServeConfig(dtype=torch.float32, **kw))
    return jb, tb


def _drain(setup, requests, max_new=8, **kw):
    """Serve ``requests`` through both batchers; returns both."""
    jb, tb = _pair(setup, **kw)
    for rid, p in requests:
        jb.submit(rid, p)
        tb.submit(rid, p)
    jb.run(max_new=max_new)
    tb.run(max_new=max_new)
    return jb, tb


def _assert_same_schedule(jb, tb):
    assert tb.results == jb.results
    assert tb.admit_order == jb.admit_order
    assert tb.kv_samples == jb.kv_samples
    assert tb.kv_utilization() == jb.kv_utilization()


# --------------------------------------------------------------------------
# kv_utilization aggregation over synthetic samples
# --------------------------------------------------------------------------

def _utilization(samples):
    """``kv_utilization()`` of a bare batcher of each package holding
    ``samples`` (live tokens, allocated capacity, live slots)."""
    out = []
    for cls in (JaxContinuousBatcher, ContinuousBatcher):
        b = cls.__new__(cls)
        b.kv_samples = samples
        out.append(b.kv_utilization())
    return out


@pytest.mark.parametrize("samples,want", [
    ([], {"mean_util": 0.0, "peak_util": 0.0, "peak_live_slots": 0,
          "samples": 0}),
    ([(10, 100, 2), (50, 100, 3), (30, 60, 1)],
     {"mean_util": (0.1 + 0.5 + 0.5) / 3, "peak_util": 0.5,
      "peak_live_slots": 3, "samples": 3}),
    # a segment sampled with nothing allocated neither divides by zero
    # nor drags the mean; live-slot peaks still count every sample
    ([(0, 0, 0), (40, 80, 4), (0, 0, 0)],
     {"mean_util": 0.5, "peak_util": 0.5, "peak_live_slots": 4,
      "samples": 3}),
], ids=["empty", "mean_peak_live_slots", "zero_capacity"])
def test_kv_utilization_matches_jax(samples, want):
    jax_u, port_u = _utilization(samples)
    assert port_u == jax_u
    assert port_u == pytest.approx(want)


def test_unknown_admission_policy_rejected(setup):
    _, _, _, model, tparams = setup
    with pytest.raises(ValueError, match="admission"):
        Batcher(model, tparams, ServeConfig(max_len=32, batch=2,
                                            admission="lifo"))
    with pytest.raises(ValueError, match="admission"):
        _pair(setup, max_len=32, batch=2, admission="lifo")


# --------------------------------------------------------------------------
# skip-ahead admission, both batchers
# --------------------------------------------------------------------------

def _mixed(cfg, seed):
    rng = np.random.default_rng(seed)
    big = rng.integers(0, cfg.vocab, size=30).tolist()
    smalls = [rng.integers(0, cfg.vocab, size=4).tolist() for _ in range(3)]
    # small first so the pool is part-full when the big head blocks
    return [(0, smalls[0]), (1, big), (2, smalls[1]), (3, smalls[2])]


def test_skip_ahead_improves_occupancy_mixed_sizes(setup):
    """Against a small pool FIFO blocks on the big request and serves it
    alone; skip-ahead admits the smalls behind it.  Tokens are the same
    either way, and each policy's schedule is JAX's."""
    requests = _mixed(setup[0], 2)
    base = dict(max_len=64, batch=3, sync_every=4, paged=True, page_size=8,
                total_pages=6)
    runs = {}
    for admission in ("fifo", "skip-ahead"):
        jb, tb = _drain(setup, requests, admission=admission, **base)
        _assert_same_schedule(jb, tb)
        runs[admission] = tb
    fifo, skip = runs["fifo"], runs["skip-ahead"]
    assert skip.results == fifo.results
    occ = {k: [s for _, _, s in b.kv_samples] for k, b in runs.items()}
    assert (fifo.kv_utilization()["peak_live_slots"]
            < skip.kv_utilization()["peak_live_slots"] == 3)
    assert (sum(occ["skip-ahead"]) / len(occ["skip-ahead"])
            > sum(occ["fifo"]) / len(occ["fifo"]))


@pytest.mark.parametrize("lookahead,peak", [(1, 1), (3, 2)])
def test_skip_ahead_lookahead_is_bounded(setup, lookahead, peak):
    """Lookahead 1 is FIFO: the admissible small request sits outside the
    window while the big head blocks; a window of 3 reaches past it."""
    cfg = setup[0]
    rng = np.random.default_rng(6)
    big = rng.integers(0, cfg.vocab, size=30).tolist()
    small = rng.integers(0, cfg.vocab, size=4).tolist()
    jb, tb = _drain(setup, [(0, small), (1, big), (2, small[:3])],
                    max_len=64, batch=2, sync_every=4, paged=True,
                    page_size=8, total_pages=6, admission="skip-ahead",
                    admission_lookahead=lookahead)
    _assert_same_schedule(jb, tb)
    assert tb.kv_utilization()["peak_live_slots"] == peak


def _aging(setup, max_skips):
    """Both batchers staged so a big head blocks while smalls fit: 14
    pages, an occupier slot pinning 8, the big request needing 7 > 6
    free."""
    pair = _pair(setup, max_len=64, batch=5, paged=True, page_size=8,
                 total_pages=14, admission="skip-ahead",
                 admission_max_skips=max_skips)
    rng = np.random.default_rng(4)
    big = rng.integers(0, 100, size=48).tolist()      # 7 pages w/ budget 8
    smalls = [rng.integers(0, 100, size=4).tolist() for _ in range(3)]
    for b in pair:
        b.pool.reserve(4, 64)          # occupier: 8 pages off the free list
        b.submit(100, big)
        for i, s in enumerate(smalls):
            b.submit(200 + i, s)
    return pair


def test_skip_ahead_aging_becomes_barrier(setup):
    """Each bypass charges the blocked head one skip; at max_skips it is a
    barrier that later smalls do not pass, though their pages fit."""
    for b in _aging(setup, max_skips=2):
        assert b._admit_next(0, 8)[0] == 200      # skip 1 charged to big
        assert b._admit_next(1, 8)[0] == 201      # skip 2 charged to big
        assert b._skips[100] == 2
        assert b._admit_next(2, 8) is None        # the aged head blocks
        assert b.queue[0][0] == 100 and len(b.queue) == 2
        b.pool.release(4)                         # pages free: head fits
        assert b._admit_next(2, 8)[0] == 100
        assert 100 not in b._skips
        assert b._admit_next(3, 8)[0] == 202
        assert b.admit_order == [200, 201, 100, 202]


def test_skip_ahead_max_skips_zero_is_fifo(setup):
    """max_skips=0 ages the head at once: skip-ahead is strict FIFO."""
    for b in _aging(setup, max_skips=0):
        assert b._admit_next(0, 8) is None
        assert len(b.queue) == 4 and not b._skips


def test_skip_ahead_aging_full_drain_parity(setup):
    """Aging changes the admission schedule only, never the tokens; each
    max_skips drains as JAX does, with no skip left over."""
    requests = _mixed(setup[0], 8)
    base = dict(max_len=64, batch=3, sync_every=4, paged=True, page_size=8,
                total_pages=6, admission="skip-ahead")
    results = {}
    for max_skips in (8, 1):
        jb, tb = _drain(setup, requests, admission_max_skips=max_skips,
                        **base)
        _assert_same_schedule(jb, tb)
        assert tb._skips == jb._skips
        assert max(tb._skips.values(), default=0) == 0
        results[max_skips] = tb.results
    assert results[8] == results[1]


# --------------------------------------------------------------------------
# metrics registry, latency and join stats, reset_stats
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 37, 5000],
                         ids=["empty", "one", "some", "decimated"])
def test_metrics_registry_matches_jax(n):
    """The same observations give the same count, sum, p50 and p95 (past
    the reservoir cap too), counters and gauges; reset clears both
    alike."""
    values = np.random.default_rng(n).exponential(0.01, size=n)
    regs = (JaxMetricsRegistry(), MetricsRegistry())
    for reg in regs:
        for v in values:
            reg.observe("lat.ttft_s", v)
        reg.inc("join.chunk_continuations", 3)
        reg.set_gauge("pool.free_pages", 7)
    want, got = (r.snapshot() for r in regs)
    assert got == want
    for reg in regs:
        assert reg.count("lat.ttft_s") == n
    assert regs[1].sum("lat.ttft_s") == regs[0].sum("lat.ttft_s")
    for q in (50, 95):
        assert (regs[1].percentile("lat.ttft_s", q)
                == regs[0].percentile("lat.ttft_s", q))
    for reg in regs:
        reg.reset()
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].count("lat.ttft_s") == 0


def _served(setup, paged):
    cfg = setup[0]
    rng = np.random.default_rng(3)
    requests = [(i, rng.integers(0, cfg.vocab,
                                 size=int(rng.integers(3, 12))).tolist())
                for i in range(5)]
    kw = dict(max_len=64, batch=2, sync_every=4, paged=paged, page_size=8)
    return requests, _drain(setup, requests, **kw)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_latency_and_join_stats_have_jax_keys(setup, paged):
    requests, (jb, tb) = _served(setup, paged)
    _assert_same_schedule(jb, tb)
    lat, jlat = tb.latency_stats(), jb.latency_stats()
    assert list(lat) == list(jlat)
    assert lat["requests"] == jlat["requests"] == len(requests)
    for key in ("preemptions", "preempted_token_recompute",
                "cancellations", "shed_requests", "deadline_met",
                "deadline_total", "watchdog_trips"):
        assert lat[key] == jlat[key] == 0, key
    assert lat["deadline_attainment"] == jlat["deadline_attainment"] == 1.0
    for key in ("ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
                "queue_wait_p50_s", "queue_wait_p95_s"):
        assert 0.0 < lat[key] < 60.0, key
    assert lat["ttft_p50_s"] <= lat["ttft_p95_s"]
    joins, jjoins = tb.join_stats(), jb.join_stats()
    assert list(joins) == list(jjoins)
    assert joins["joins"] == jjoins["joins"] == tb.joins
    assert joins["chunk_joins"] == joins["budget_deferrals"] == 0
    assert 0.0 < joins["mean_join_s"] <= joins["max_join_s"]
    assert tb.metrics.count("lat.tpot_s") == jb.metrics.count("lat.tpot_s")
    assert (tb.metrics.count("lat.queue_wait_s")
            == jb.metrics.count("lat.queue_wait_s") == len(requests))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_reset_stats_then_warm_wave(setup, paged):
    """``reset_stats`` clears the wave's stats and keeps what the next
    wave needs; a second wave of the same prompts into the warm batcher
    gives the same tokens, and its stats describe it alone."""
    requests, (_, tb) = _served(setup, paged)
    first = dict(tb.results)
    joins, segments = tb.joins, tb.segments
    tb.reset_stats()
    assert tb.latency_stats()["requests"] == 0
    assert tb.join_stats()["joins"] == 0
    assert tb.kv_utilization()["samples"] == 0
    assert tb.metrics.snapshot() == {
        "lat.ttft_s.count": 0, "lat.ttft_s.sum": 0.0, "lat.ttft_s.p50": 0.0,
        "lat.ttft_s.p95": 0.0, "lat.tpot_s.count": 0, "lat.tpot_s.sum": 0.0,
        "lat.tpot_s.p50": 0.0, "lat.tpot_s.p95": 0.0,
        "lat.queue_wait_s.count": 0, "lat.queue_wait_s.sum": 0.0,
        "lat.queue_wait_s.p50": 0.0, "lat.queue_wait_s.p95": 0.0,
        "join.seconds.count": 0, "join.seconds.sum": 0.0,
        "join.seconds.p50": 0.0, "join.seconds.p95": 0.0}
    assert (tb.joins, tb.segments) == (joins, segments)
    for rid, p in requests:
        tb.submit(100 + rid, p)
    tb.run(max_new=8)
    for rid, _ in requests:
        assert tb.results[100 + rid] == first[rid], rid
    assert tb.latency_stats()["requests"] == len(requests)
    assert tb.join_stats()["joins"] == tb.joins - joins
    assert tb.kv_utilization()["samples"] == tb.segments - segments


# --------------------------------------------------------------------------
# state written in place; graphs; launch tally
# --------------------------------------------------------------------------

def _addresses(b):
    state = [b.tok, b.lengths, b.done, b.remaining]
    caches = [c[name] for c in b.caches for name in ("k", "v")]
    return [t.data_ptr() for t in state + caches]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_slot_state_keeps_its_tensors(setup, paged):
    """Joins and decode segments write the slot state, the caches and the
    page-table slices in place: every tensor a decode graph would read
    keeps its address for the batcher's life."""
    cfg, _, _, model, tparams = setup
    b = Batcher(model, tparams, ServeConfig(
        dtype=torch.float32, max_len=64, batch=2, sync_every=3, paged=paged,
        page_size=8))
    before = _addresses(b)
    rng = np.random.default_rng(9)
    for rid in range(5):
        b.submit(rid, rng.integers(0, cfg.vocab,
                                   size=int(rng.integers(3, 30))).tolist())
    pages_at: dict[int, int] = {}
    segment = b._decode_segment

    def watched(steps):
        out = segment(steps)
        assert _addresses(b) == before
        for cap, t in b._pages.items():
            assert pages_at.setdefault(cap, t.data_ptr()) == t.data_ptr()
        return out
    b._decode_segment = watched
    b.run(max_new=9)
    assert b.joins > 1 and b.segments > 2
    assert _addresses(b) == before
    assert len(b.results) == 5
    assert not b.graphs and b.graph_count == 0 and b.capture_seconds == 0.0
    if paged:
        assert pages_at and all(t.shape == (2, cap)
                                for cap, t in b._pages.items())
        assert {cap for _, cap, _ in b._loops} == set(b._pages)


def test_graphs_on_the_cpu_refused(setup):
    _, _, _, model, tparams = setup
    with pytest.raises(ValueError, match="CUDA"):
        Batcher(model, tparams, ServeConfig(max_len=32, batch=2,
                                            dtype=torch.float32),
                graphs=True)
    assert not Batcher(model, tparams, ServeConfig(
        max_len=32, batch=2, dtype=torch.float32)).graphs


def test_launch_tally_counts_replays(monkeypatch):
    """A launch outside capture counts at once; one inside a capture goes
    to the open recording's tally (or nowhere, with none open), and each
    replay adds the tally."""
    counts = {"k1": 0}
    other = {"k2": 0}
    capturing = [False]
    monkeypatch.setattr(launches.torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    launches.count(counts, "k1")
    assert counts == {"k1": 1}
    capturing[0] = True
    launches.count(counts, "k1")                 # no recording open
    with launches.recording() as tally:
        for _ in range(3):
            launches.count(counts, "k1")
        launches.count(other, "k2")
    capturing[0] = False
    assert counts == {"k1": 1} and other == {"k2": 0}
    assert tally == {"k1": 3, "k2": 1}
    for _ in range(2):
        launches.replayed(tally)
    assert counts == {"k1": 7} and other == {"k2": 2}
