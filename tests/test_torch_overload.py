"""Overload protection in the port (deadlines and cancellation, the
degradation ladder, the progress watchdog, chaos ``stall_at`` and
``burst_at``, the flight bundle), against the JAX package on the same
float32 weights at qwen2-0.5b ``reduced()``: each of the 24 deterministic
cases of ``tests/test_overload.py``, the same traffic and configuration
through both, compared exactly.

The policy units (``DegradationController``, ``project_finish_s``,
``Watchdog``) run the same seeded signal sequences through both packages
with an injected clock: equal states, transitions and statistics.  The
scheduler cases compare ``results``, ``cancelled``, ``rejections``,
``overload_stats()`` without its time in state (the transitions whole:
no SLO is set, so their burn is 0), ``latency_stats()`` counters,
``slo_stats()`` counts, ``preempt_stats()``, the admission order, the
rounds and the chaos events, and the flight bundle's keys, slot table,
queue, pool and error type; each drain leaves ``KVPool.check()`` green
with no page in use.  Each case also holds the port to the JAX test's
own assertions.  A port-only hypothesis test mixes overload, optimistic
preemption, chunks, speculation and chaos stalls and bursts
(``max_examples=5, derandomize=True, database=None``): every submitted
request ends in exactly one of ``results`` or ``cancelled``, the pool
drains, and every completed stream is the unloaded run's (or differs at
a shown float32 logit near-tie, 1e-4)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve import overload as jov
from repro.serve.attribution import explain as jax_explain
from repro.serve.chaos import ChaosInjector as JaxChaos
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Batcher as JaxBatcher
from repro.serve.telemetry import MetricsRegistry as JaxRegistry
from repro.serve.telemetry import Tracer as JaxTracer
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import forward, logits_fn
from repro_torch.serve import overload as tov
from repro_torch.serve.attribution import explain
from repro_torch.serve.chaos import ChaosInjector
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Batcher
from repro_torch.serve.telemetry import MetricsRegistry, Tracer

torch.set_num_threads(1)

NEAR_TIE = 1e-4
BASE = dict(max_len=96, batch=6, sync_every=4, paged=True, page_size=8,
            total_pages=24, admission_mode="optimistic")
LAT_COUNTS = ("requests", "preemptions", "preempted_token_recompute",
              "cancellations", "shed_requests", "deadline_met",
              "deadline_total", "deadline_attainment", "watchdog_trips")


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-0.5b").reduced()
    jmodel = JaxModel(jax_get_config("qwen2-0.5b").reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), tparams


def _pair(setup, chaos=None, **kw):
    """The JAX and the port batcher on one configuration (float32);
    ``chaos`` is the keyword dict of a ChaosInjector for each."""
    _, jmodel, jparams, model, tparams = setup
    jb = JaxBatcher(jmodel, jparams,
                    JaxServeConfig(**{**BASE, "dtype": jnp.float32, **kw}),
                    chaos=JaxChaos(**chaos) if chaos is not None else None)
    tb = Batcher(model, tparams,
                 ServeConfig(**{**BASE, "dtype": torch.float32, **kw}),
                 chaos=ChaosInjector(**chaos) if chaos is not None else None)
    return jb, tb


def _requests(cfg, n=6, lo=8, hi=14, seed=1):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab,
                             size=int(rng.integers(lo, hi))).tolist())
            for i in range(n)]


def _ostats(b) -> dict:
    """``overload_stats()`` without its host-clock time in state."""
    st = b.overload_stats()
    st["controller"] = {k: v for k, v in st["controller"].items()
                        if k != "time_in_state"}
    return st


def _assert_matches_jax(jb, tb):
    """The port's run against JAX's: tokens, terminal states, ledgers,
    counters, schedule and chaos events, exactly."""
    assert tb.results == jb.results
    assert tb.cancelled == jb.cancelled
    assert tb.rejections == jb.rejections
    assert _ostats(tb) == _ostats(jb)
    lat, jlat = tb.latency_stats(), jb.latency_stats()
    assert list(lat) == list(jlat)
    for key in LAT_COUNTS:
        assert lat[key] == jlat[key], key
    slo, jslo = tb.slo_stats(), jb.slo_stats()
    for key in ("enabled", "classes", "slo_attainment"):
        assert slo[key] == jslo[key], key
    assert tb.preempt_stats() == jb.preempt_stats()
    assert tb.admit_order == jb.admit_order
    assert tb.round == jb.round
    if jb.chaos is not None:
        assert tb.chaos.events == jb.chaos.events


def _assert_drained(b):
    b.pool.check()
    assert b.pool.used_pages == 0


def _drain(setup, requests, max_new, chaos=None, submit=None, **kw):
    """Serve ``requests`` through both batchers (``submit``: extra
    keywords of each ``submit``, by rid); returns (JAX's, the port's)."""
    jb, tb = _pair(setup, chaos=chaos, **kw)
    for b in (jb, tb):
        for rid, p in requests:
            b.submit(rid, p, **(submit or {}).get(rid, {}))
        b.run(max_new=max_new)
    return jb, tb


# ---------------------------------------------------------------------------
# DegradationController, with an injected clock
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _trajectory(mod, signals, **kw):
    """Feed ``signals`` [(burn, pressure, queue)] to one package's
    controller on a clock advancing 0.25 s a round; returns every state,
    the rung properties each round, the transitions, the final stats and
    the stats after ``reset``."""
    clk = FakeClock()
    ctl = mod.DegradationController(clock=clk, **kw)
    states = []
    for r, (burn, pressure, queue) in enumerate(signals):
        clk.t = 0.25 * (r + 1)
        states.append((ctl.observe(burn=burn, pressure=pressure,
                                   queue_depth=queue, round=r),
                       ctl.shed_speculation, ctl.shrink_chunk,
                       ctl.freeze_growth, ctl.shedding,
                       ctl.recovered_to_healthy))
    clk.t += 1.0
    stats = ctl.stats()
    ctl.reset()
    return states, list(ctl.transitions), stats, ctl.stats(), ctl.state


def test_controller_climbs_and_descends_with_hysteresis():
    """JAX's climb-and-recover sequence, then seeded random signals: the
    same states, rung properties, transitions, time in state (to the
    clock's tick) and reset, in both packages."""
    spec = ([(1.5, 0.0, 0), (0.0, 0.0, 0), (1.5, 0.0, 0)]
            + [(1.5, 0.0, 0)] * 2 + [(2.5, 0.0, 0)] * 2
            + [(0.0, 0.0, 0)] * 6)
    got = _trajectory(tov, spec, up_rounds=2, down_rounds=3)
    assert got == _trajectory(jov, spec, up_rounds=2, down_rounds=3)
    assert [s for s, *_ in got[0]][2] == tov.HEALTHY
    assert got[2]["recovered_to_healthy"]
    assert [(f, t) for _, f, t, _, _ in got[2]["transitions"]] == [
        (tov.HEALTHY, tov.DEGRADED), (tov.DEGRADED, tov.SHEDDING),
        (tov.SHEDDING, tov.DEGRADED), (tov.DEGRADED, tov.HEALTHY)]
    rng = np.random.default_rng(7)
    for up, down in ((1, 1), (2, 4), (3, 2)):
        signals = [(float(rng.choice([0.0, 0.5, 1.2, 2.4])),
                    float(rng.choice([0.0, 0.5, 0.95, 1.0])),
                    int(rng.integers(0, 3))) for _ in range(60)]
        assert (_trajectory(tov, signals, up_rounds=up, down_rounds=down)
                == _trajectory(jov, signals, up_rounds=up,
                               down_rounds=down))


def test_controller_severity_pressure_needs_queue_for_shed():
    ctl, jctl = tov.DegradationController(), jov.DegradationController()
    for burn in (0.0, 0.95, 1.0, 1.5, 2.0, 3.0):
        for pressure in (0.0, 0.5, 0.9, 0.99, 1.0):
            for queue in (0, 1, 3):
                assert (ctl.severity(burn, pressure, queue)
                        == jctl.severity(burn, pressure, queue))
    assert ctl.severity(burn=0.0, pressure=1.0, queue_depth=0) == 1
    assert ctl.severity(burn=0.0, pressure=1.0, queue_depth=3) == 2
    assert ctl.severity(burn=0.95, pressure=0.0, queue_depth=9) == 0


def test_controller_rung_properties():
    signals = [(1.5, 0.0, 0), (2.5, 0.0, 0)]
    got = _trajectory(tov, signals, up_rounds=1)
    assert got == _trajectory(jov, signals, up_rounds=1)
    (deg, *deg_props), (shed, *shed_props) = got[0]
    assert deg == tov.DEGRADED and deg_props[:4] == [True, True, False,
                                                       False]
    assert shed == tov.SHEDDING and shed_props[:4] == [True, True, True,
                                                         True]


def test_controller_time_in_state_and_reset():
    def run(mod):
        clk = FakeClock()
        ctl = mod.DegradationController(up_rounds=1, clock=clk)
        clk.t = 5.0
        ctl.observe(burn=1.5, pressure=0.0, queue_depth=0)
        clk.t = 7.0
        before = ctl.stats()
        ctl.reset()
        return before, ctl.stats(), ctl.state
    got = run(tov)
    assert got == run(jov)
    assert got[0]["time_in_state"][tov.HEALTHY] == pytest.approx(5.0)
    assert got[0]["time_in_state"][tov.DEGRADED] == pytest.approx(2.0)
    assert got[2] == tov.DEGRADED
    assert got[1]["time_in_state"][tov.DEGRADED] == pytest.approx(0.0)
    assert not got[1]["transitions"] and not got[1]["recovered_to_healthy"]


@pytest.mark.parametrize("kw", [
    dict(up_rounds=0), dict(down_rounds=0),
    dict(degrade_burn=3.0, shed_burn=2.0), dict(degrade_burn=0.0),
    dict(degrade_pressure=0.9, shed_pressure=0.5),
    dict(shed_pressure=1.5)],
    ids=["up", "down", "burn-order", "burn-zero", "pressure-order",
         "pressure-above-1"])
def test_controller_validates_thresholds(kw):
    messages = []
    for mod in (jov, tov):
        with pytest.raises(ValueError) as err:
            mod.DegradationController(**kw)
        messages.append(str(err.value))
    assert messages[1] == messages[0]


# ---------------------------------------------------------------------------
# project_finish_s and Watchdog
# ---------------------------------------------------------------------------

def _projections(reg_cls, mod, ttfts, tpots):
    m = reg_cls()
    out = [mod.project_finish_s(m, 10, queued=True),
           mod.project_finish_s(m, 10, queued=False)]
    for ttft, tpot in zip(ttfts, tpots):
        if ttft is not None:
            m.observe("lat.ttft_s", ttft)
        if tpot is not None:
            m.observe("lat.tpot_s", tpot)
        out += [mod.project_finish_s(m, n, queued=q)
                for n in (0, 1, 7) for q in (True, False)]
    return out


def test_projection_abstains_without_samples():
    for ttfts, tpots in (([2.0], [None]), ([None, 1.0], [None, None])):
        got = _projections(MetricsRegistry, tov, ttfts, tpots)
        assert got == _projections(JaxRegistry, jov, ttfts, tpots)
    m = MetricsRegistry()
    assert tov.project_finish_s(m, 10, queued=True) is None
    m.observe("lat.ttft_s", 2.0)
    assert tov.project_finish_s(m, 10, queued=True) == pytest.approx(2.0)
    assert tov.project_finish_s(m, 10, queued=False) is None


def test_projection_uses_observed_means():
    rng = np.random.default_rng(11)
    ttfts = rng.uniform(0.01, 3.0, 40).tolist()
    tpots = rng.uniform(0.001, 0.5, 40).tolist()
    got = _projections(MetricsRegistry, tov, ttfts, tpots)
    assert got == _projections(JaxRegistry, jov, ttfts, tpots)
    m = MetricsRegistry()
    for v in (1.0, 3.0):
        m.observe("lat.ttft_s", v)
    m.observe("lat.tpot_s", 0.5)
    assert tov.project_finish_s(m, 5, queued=True) == pytest.approx(4.0)
    assert tov.project_finish_s(m, 5, queued=False) == pytest.approx(2.5)


def test_watchdog_trips_and_rearms():
    rng = np.random.default_rng(3)
    prints = [(int(v),) for v in np.cumsum(rng.random(200) < 0.2)]
    for limit in (1, 3, 5):
        wd, jwd = tov.Watchdog(limit), jov.Watchdog(limit)
        assert ([wd.tick(f) for f in prints]
                == [jwd.tick(f) for f in prints])
        assert (wd.trips, wd.stalled_rounds) == (jwd.trips,
                                                 jwd.stalled_rounds)
    wd = tov.Watchdog(limit=3)
    assert [wd.tick(f) for f in [(1,), (2,), (2,), (2,), (2,), (2,), (2,),
                                 (2,)]] == [False] * 4 + [True, False,
                                                          False, True]
    with pytest.raises(ValueError, match=">= 1"):
        tov.Watchdog(limit=0)


def test_watchdog_rounds_config_validated(setup):
    messages = []
    for make in (lambda: _pair(setup, watchdog_rounds=0),
                 lambda: Batcher(setup[3], setup[4], ServeConfig(
                     **{**BASE, "dtype": torch.float32},
                     watchdog_rounds=0))):
        with pytest.raises(ValueError, match="watchdog") as err:
            make()
        messages.append(str(err.value))
    assert messages[1] == messages[0]


# ---------------------------------------------------------------------------
# cancellation: queued, mid-flight, reasons, accounting
# ---------------------------------------------------------------------------

def test_client_cancel_queued_request(setup):
    outcomes = []
    for b in _pair(setup):
        b.submit(0, [1, 2, 3])
        b.submit(1, [4, 5, 6])
        outcomes.append((b.cancel(0), dict(b.cancelled),
                         [rid for rid, _ in b.queue], b.cancel(0),
                         b.cancel(99), _ostats(b)))
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][:5] == (True, {0: "client"}, [1], False, False)
    assert outcomes[1][5]["cancelled_by_reason"]["client"] == 1


def test_cancel_rejects_unknown_reason(setup):
    messages = []
    for b in _pair(setup):
        b.submit(0, [1, 2, 3])
        with pytest.raises(ValueError, match="cancel reason") as err:
            b.cancel(0, reason="bored")
        messages.append(str(err.value))
    assert messages[1] == messages[0]


def test_midflight_cancel_releases_pages(setup):
    """A planted live slot cancelled: its pages drain, its device row is
    latched done (in place in the port) and the pool checks out."""
    seen = []
    for b in _pair(setup):
        b.pool.reserve(2, 32)
        b.slot_rid[2] = 7
        b.slot_prompt[2] = list(range(32))
        b.slot_len[2] = 32
        b.slot_filled[2] = 32
        b.slot_max_tokens[2] = 48
        used = b.pool.used_pages
        done = b.done
        assert b.cancel(7)
        b.pool.check()
        seen.append((used, dict(b.cancelled), b.slot_rid[2],
                     b.pool.used_pages, bool(b.done[2]),
                     int(b.remaining[2]), b.pool.snapshot(), _ostats(b)))
    assert done is b.done                         # the port's, in place
    assert seen[1] == seen[0]
    assert seen[1][:6] == (4, {7: "client"}, None, 0, True, 0)


def test_deadline_zero_cancels_before_any_work(setup):
    cfg = setup[0]
    jb, tb = _drain(setup, _requests(cfg, n=3), 4,
                    submit={0: dict(deadline_s=0.0)})
    _assert_matches_jax(jb, tb)
    assert tb.cancelled == {0: "deadline"}
    assert sorted(tb.results) == [1, 2]
    st = tb.overload_stats()
    assert st["deadline_total"] == 1 and st["deadline_met"] == 0
    assert st["deadline_attainment"] == 0.0
    _assert_drained(tb)


def test_timeout_beats_deadline_as_reason(setup):
    jb, tb = _drain(setup, [(0, [1, 2, 3, 4]), (1, [5, 6, 7, 8])], 4,
                    submit={0: dict(deadline_s=0.0, timeout_s=0.0)})
    _assert_matches_jax(jb, tb)
    assert tb.cancelled == {0: "timeout"}
    assert tb.overload_stats()["deadline_total"] == 1
    _assert_drained(tb)


def test_generous_deadlines_all_met(setup):
    requests = _requests(setup[0], n=4)
    jb, tb = _drain(setup, requests, 4,
                    submit={rid: dict(deadline_s=600.0)
                            for rid, _ in requests})
    _assert_matches_jax(jb, tb)
    assert sorted(tb.results) == [r for r, _ in requests]
    st = tb.overload_stats()
    assert st["deadline_total"] == st["deadline_met"] == 4
    assert st["deadline_attainment"] == 1.0 and not tb.cancelled
    _assert_drained(tb)


def _plain_events(tracer) -> dict:
    """Each rid's timeline without its host-clock fields."""
    return {rid: [{k: v for k, v in e.items()
                   if k not in ("t", "ttft_s", "tpot_s")}
                  for e in tracer.timeline(rid)]
            for rid in tracer.rids()}


def test_cancel_traced_and_perfetto_terminal(tmp_path, setup):
    """The CANCEL event on the rid's timeline with its reason, and the
    Perfetto export closing its queue span: the port's timelines are
    JAX's, and so is the export's event sequence."""
    jb, tb = _drain(setup, [(0, [1, 2, 3]), (1, [4, 5, 6])], 3,
                    submit={0: dict(deadline_s=0.0)}, telemetry=True)
    _assert_matches_jax(jb, tb)
    assert _plain_events(tb.telemetry) == _plain_events(jb.telemetry)
    ev = [e for e in tb.telemetry.timeline(0) if e["kind"] == "CANCEL"]
    assert len(ev) == 1 and ev[0]["reason"] == "deadline"
    out = tmp_path / "trace.json"
    tb.telemetry.to_perfetto(str(out))
    data = json.loads(out.read_text())
    names = [(e.get("ph"), e.get("name")) for e in data["traceEvents"]]
    assert names == [(e.get("ph"), e.get("name")) for e in
                     jb.telemetry.to_perfetto()["traceEvents"]]
    assert ("i", "CANCEL") in names
    q = [e["ph"] for e in data["traceEvents"]
         if e.get("id") == 0 and e["ph"] in ("b", "e")]
    assert q.count("b") == q.count("e") >= 1


def test_attribution_carries_cancel_reason():
    """A request cancelled after its first token attributes like a
    retired one, with ``cancelled`` naming the reason."""
    got = []
    for tracer_cls, explain_fn in ((Tracer, explain),
                                   (JaxTracer, jax_explain)):
        tr = tracer_cls()
        tr.event("SUBMIT", 5, t=0.0, prompt_tokens=3)
        tr.event("ADMIT", 5, t=0.5, slot=0)
        tr.event("FIRST_TOKEN", 5, t=1.0, slot=0, token=9, ttft_s=1.0)
        tr.event("CANCEL", 5, t=1.5, slot=0, reason="timeout")
        a = explain_fn(tr, 5)
        a.check()
        got.append((a.cancelled, a.ttft_s, a.ttft, a.tpot, a.preemptions))
    assert got[0] == got[1]
    assert got[0][0] == "timeout"


# ---------------------------------------------------------------------------
# shedding, the watchdog drill, the chaos burst
# ---------------------------------------------------------------------------

def test_shed_queued_lowest_priority_first_with_retry_after(setup):
    seen = []
    for b in _pair(setup, overload=True, overload_queue_keep=2):
        for rid, prio in ((0, 1), (1, 0), (2, 0), (3, 2)):
            b.submit(rid, [1, 2, 3], priority=prio)
        b._resumed.add(2)               # a paid-for resume: never shed
        b.overload.state = tov.SHEDDING
        b._shed_queued()
        seen.append(([rid for rid, _ in b.queue], dict(b.cancelled),
                     _ostats(b)))
    assert seen[1] == seen[0]
    queue, cancelled, st = seen[1]
    assert queue == [2, 3]
    assert cancelled == {0: "shed", 1: "shed"}
    assert st["shed_requests"] == 2 and st["deadline_total"] == 0
    assert [r["status"] for r in st["rejections"]] == [tov.RETRY_AFTER] * 2
    assert all(r["retry_after_s"] > 0 for r in st["rejections"])


def _bundle(b) -> dict:
    """The comparable part of a flight bundle."""
    d = b.last_flight_bundle
    return {"keys": sorted(d), "slot_table": d["slot_table"],
            "queue": d["queue"], "pool": d["pool"],
            "error": d["error"].split(":")[0], "round": d["round"],
            "preempt_events": [list(e) for e in d["preempt_events"]],
            "events": [{k: v for k, v in e.items()
                        if k not in ("t", "ttft_s", "tpot_s")}
                       for e in d["events"]]}


def test_watchdog_drill_sheds_and_dumps_bundle(tmp_path, setup,
                                               monkeypatch):
    """A chaos stall past the watchdog bound: neither run raises, both
    dump the flight bundle through $REPRO_FLIGHT_PATH, shed the blocking
    head and finish the rest, alike."""
    cfg = setup[0]
    requests = _requests(cfg, n=5)
    jb, tb = _pair(setup, chaos=dict(stall_at={2: 12},
                                     check_invariants=True),
                   watchdog_rounds=4)
    disk = {}
    for name, b in (("jax", jb), ("port", tb)):
        path = tmp_path / f"{name}.json"
        monkeypatch.setenv("REPRO_FLIGHT_PATH", str(path))
        for rid, p in requests:
            b.submit(rid, p)
        b.run(max_new=6)
        disk[name] = json.loads(path.read_text())
    _assert_matches_jax(jb, tb)
    assert _bundle(tb) == _bundle(jb)
    st = tb.overload_stats()
    assert st["watchdog_trips"] >= 1
    assert st["cancelled_by_reason"]["shed"] >= 1
    assert set(tb.results) | set(tb.cancelled) == {r for r, _ in requests}
    assert set(tb.results).isdisjoint(tb.cancelled)
    data = disk["port"]
    assert data["schema"] == 1 and "WatchdogStall" in data["error"]
    assert data["pool"] is not None
    assert tb.last_flight_bundle["error"] == data["error"]
    assert any(kind == "stall" for _, kind, _ in tb.chaos.events)
    _assert_drained(tb)


def test_watchdog_survives_stall_shorter_than_limit(setup):
    jb, tb = _drain(setup, _requests(setup[0], n=3), 4,
                    chaos=dict(stall_at={2: 3}), watchdog_rounds=10)
    _assert_matches_jax(jb, tb)
    assert sorted(tb.results) == [0, 1, 2]
    assert tb.overload_stats()["watchdog_trips"] == 0 and not tb.cancelled
    _assert_drained(tb)


def test_chaos_burst_is_deterministic(setup):
    """A burst of 3 at round 1: JAX's synthetic prompts, tokens and
    events, and the port's second run repeats its first."""
    requests = _requests(setup[0], n=3)
    chaos = dict(burst_at={1: 3}, check_invariants=True)
    jb, tb = _drain(setup, requests, 4, chaos=chaos)
    _, tb2 = _drain(setup, requests, 4, chaos=chaos)
    _assert_matches_jax(jb, tb)
    burst = [ChaosInjector.BURST_RID0 + i for i in range(3)]
    assert burst == [JaxChaos.BURST_RID0 + i for i in range(3)]
    for rid in burst:
        assert rid in tb.results and tb.results[rid] == tb2.results[rid]
        assert (tb.chaos._burst_prompt(tb, rid)
                == jb.chaos._burst_prompt(jb, rid))
    assert any(kind == "burst" for _, kind, _ in tb.chaos.events)
    assert tb.chaos.events == tb2.chaos.events
    _assert_drained(tb)


# ---------------------------------------------------------------------------
# a degraded run changes the schedule, never the tokens
# ---------------------------------------------------------------------------

def test_degraded_run_is_bit_exact_for_completing_requests(setup):
    """The ladder forced to DEGRADED from the first round with speculation
    and chunks armed (both shed or shrunk): the port's tokens are its
    unloaded run's and JAX's degraded run's, with JAX's transitions,
    schedule and counters, and its drafter history is JAX's mirror."""
    cfg = setup[0]
    rng = np.random.default_rng(6)
    tok = int(rng.integers(0, cfg.vocab))
    requests = [(i, [tok] * int(rng.integers(10, 16))) for i in range(9)]
    kw = dict(speculate_k=2, prefill_chunk=16, sync_every=2)
    _, ref = _drain(setup, requests, 8, **kw)
    jb, tb = _drain(setup, requests, 8, overload=True,
                    overload_degrade_pressure=0.01,
                    overload_shed_pressure=1.0, overload_up_rounds=1,
                    overload_down_rounds=50, **kw)
    _assert_matches_jax(jb, tb)
    assert tb.results == ref.results
    assert tb.spec_stats() == jb.spec_stats()
    assert tb.join_stats()["chunk_joins"] == jb.join_stats()["chunk_joins"]
    st = tb.overload_stats()["controller"]
    assert st["state"] != tov.HEALTHY and st["transitions"]
    assert not tb.cancelled
    # speculation was shed: plain segments ran beside verify ones, and
    # their commits kept the drafter's history warm, as JAX's mirror is
    assert {spec for _, _, spec in tb._loops} == {False, True}
    np.testing.assert_array_equal(
        tb.history[:, :BASE["max_len"]].numpy(), jb.history)
    _assert_drained(tb)


# ---------------------------------------------------------------------------
# the stats surface
# ---------------------------------------------------------------------------

def test_stats_carry_overload_keys(setup):
    jb, tb = _drain(setup, _requests(setup[0], n=2), 3)
    _assert_matches_jax(jb, tb)
    lat = tb.latency_stats()
    assert list(lat) == list(jb.latency_stats())
    assert lat["deadline_attainment"] == 1.0
    st = tb.overload_stats()
    assert list(st) == list(jb.overload_stats())
    assert st["enabled"] is False
    assert st["controller"]["state"] == tov.HEALTHY
    assert set(st["controller"]["time_in_state"]) == set(tov.STATES)
    assert list(tb.slo_stats()) == list(jb.slo_stats())


def test_reset_stats_clears_overload_ledgers(setup):
    seen = []
    for b in _pair(setup, overload=True, overload_queue_keep=0):
        b.submit(0, [1, 2, 3])
        b.overload.state = tov.SHEDDING
        b._shed_queued()
        before = _ostats(b)
        b.reset_stats()
        seen.append((before, _ostats(b), b.overload.state))
    assert seen[1] == seen[0]
    before, after, state = seen[1]
    assert before["shed_requests"] == 1
    assert after["cancellations"] == after["shed_requests"] == 0
    assert not after["rejections"] and not after["controller"]["transitions"]
    assert state == tov.SHEDDING


# ---------------------------------------------------------------------------
# hypothesis: overload x preemption x chunks x speculation x chaos
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(setup):
    """The port's unloaded oracle: reserve admission on an ample pool,
    no feature, one run per request set and budget."""
    cache = {}

    def ref(requests, max_new):
        key = (tuple((rid, tuple(p)) for rid, p in requests), max_new)
        if key not in cache:
            b = Batcher(setup[3], setup[4], ServeConfig(
                **{**BASE, "dtype": torch.float32,
                   "admission_mode": "reserve", "total_pages": 96}))
            for rid, p in requests:
                b.submit(rid, p)
            cache[key] = b.run(max_new=max_new)
        return cache[key]
    return ref


def _same_or_near_tie(setup, prompt, got, want):
    """Equal streams, or a first difference at a near-tie of the port's
    float32 logits after the common prefix; else fail."""
    cfg, tparams = setup[0], setup[4]
    if got == want:
        return
    diff = [j for j in range(min(len(got), len(want))) if got[j] != want[j]]
    assert diff, ("equal prefix, different lengths", got, want)
    i = diff[0]
    hidden, _ = forward(tparams, {"tokens": torch.tensor([prompt + got[:i]])},
                        cfg, dtype=torch.float32)
    logits = logits_fn(tparams, hidden[:, -1:], cfg)[0, 0]
    gap = abs(float(logits[got[i]] - logits[want[i]]))
    assert gap < NEAR_TIE, (f"streams differ at token {i} without a "
                            f"near-tie (gap {gap})", got, want)


@settings(max_examples=5, deadline=None, derandomize=True, database=None)
@given(st.data())
def test_stress_overload_invariants(setup, reference, data):
    """Random overloaded traffic with the controller on, optimistic
    admission on a small pool, chunks or speculation, a chaos stall and
    a chaos burst (deadline-stamped or not), with per-round invariant
    checks: every rid ends in exactly one of results or cancelled, the
    pool drains, and every completed stream is the unloaded run's."""
    cfg = setup[0]
    rng = np.random.default_rng(data.draw(st.integers(0, 2**16),
                                          label="seed"))
    n_req = data.draw(st.integers(3, 8), label="n_req")
    requests = [(i, rng.integers(0, cfg.vocab,
                                 size=int(rng.integers(6, 20))).tolist())
                for i in range(n_req)]
    max_new = data.draw(st.integers(4, 10), label="max_new")
    kw: dict = dict(
        total_pages=data.draw(st.integers(10, 16), label="pages"),
        overload=True,
        overload_degrade_pressure=data.draw(
            st.sampled_from([0.01, 0.5, 0.9]), label="degrade_pressure"),
        overload_up_rounds=data.draw(st.integers(1, 2), label="up"),
        overload_down_rounds=data.draw(st.integers(1, 4), label="down"),
        overload_queue_keep=data.draw(st.sampled_from([None, 0, 2]),
                                      label="keep"),
        watchdog_rounds=data.draw(st.integers(3, 8), label="watchdog"))
    if data.draw(st.booleans(), label="chunked?"):
        kw["prefill_chunk"] = 8
    if data.draw(st.booleans(), label="spec?"):
        kw["speculate_k"] = 2
    chaos = ChaosInjector(
        stall_at={data.draw(st.integers(2, 4), label="stall_round"):
                  data.draw(st.integers(1, 10), label="stall_len")},
        burst_at={data.draw(st.integers(1, 5), label="burst_round"):
                  data.draw(st.integers(1, 6), label="burst_n")},
        burst_deadline_s=data.draw(st.sampled_from([None, 0.0, 600.0]),
                                   label="burst_deadline"),
        check_invariants=True)
    b = Batcher(setup[3], setup[4],
                ServeConfig(**{**BASE, "dtype": torch.float32, **kw}),
                chaos=chaos)
    for rid, p in requests:
        b.submit(rid, p, priority=int(rng.integers(0, 2)))
    b.run(max_new=max_new)
    burst = sorted(rid for rid in set(b.results) | set(b.cancelled)
                   if rid >= ChaosInjector.BURST_RID0)
    assert len(burst) == sum(n for _, kind, n in chaos.events
                             if kind == "burst")
    submitted = {rid for rid, _ in requests} | set(burst)
    assert set(b.results) | set(b.cancelled) == submitted
    assert set(b.results).isdisjoint(b.cancelled)
    assert not b.queue and all(r is None for r in b.slot_rid)
    _assert_drained(b)
    assert b.pool.held_pages == 0
    everything = requests + [(rid, chaos._burst_prompt(b, rid))
                             for rid in burst]
    want = reference(everything, max_new)
    prompts = dict(everything)
    for rid, toks in b.results.items():
        _same_or_near_tie(setup, prompts[rid], toks, want[rid])
