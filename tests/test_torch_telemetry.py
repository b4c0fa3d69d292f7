"""The port's ``Tracer`` and latency attribution against the JAX
package's, and the traced batcher against JAX's traced batcher, on the
same float32 weights at qwen2-0.5b ``reduced()``.

- The tracer on seeded event, span and pool-gauge sequences with an
  injected clock: equal events, ``rids``, ``timelines``, ring ``tail``
  and ``to_perfetto`` JSON (its process is named for the port; every
  other record equal).
- ``explain`` and ``attribution_report`` on seeded lifecycles built into
  both packages' tracers: every component within 1e-9.
- The traced batcher, port against JAX, on plain, preempting (chaos
  exhaustion), chunked and speculative traffic: per rid, equal kinds,
  rounds, slots and every attribute that is not a host time; traced
  and untraced runs give equal tokens.
- The spec cases of ``tests/test_telemetry.py`` and
  ``tests/test_attribution.py`` that do not drive JAX's kernels or its
  ``check_bench`` script, run on the port: lifecycle completeness,
  preempt/resume pairs, chaos instants, the pool gauge, scheduler spans,
  the Perfetto schema, legacy stats views, ``reset_stats``, the
  zero-overhead-off wiring, exact attribution partitions (1e-6 of the
  measured latency, JAX's own tolerance), the SLO monitor and the
  flight recorder."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve import attribution as jattr
from repro.serve import telemetry as jtel
from repro.serve.chaos import ChaosInjector as JaxChaos
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Batcher as JaxBatcher
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.serve import attribution as tattr
from repro_torch.serve import telemetry as ttel
from repro_torch.serve.attribution import (TPOT_COMPONENTS, TTFT_COMPONENTS,
                                           attribution_report, explain)
from repro_torch.serve.chaos import ChaosInjector
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.kvpool import PageError
from repro_torch.serve.scheduler import Batcher
from repro_torch.serve.telemetry import (CHAOS_KINDS, LIFECYCLE_KINDS,
                                         Tracer, _pct)

torch.set_num_threads(1)

ATTR_TOL = 1e-9
BASE = dict(max_len=96, batch=6, sync_every=4, paged=True, page_size=8,
            total_pages=10, admission_mode="optimistic")
HOST_TIMES = ("t", "ttft_s", "tpot_s")


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-0.5b").reduced()
    jmodel = JaxModel(jax_get_config("qwen2-0.5b").reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), tparams


def _requests(cfg, n=5, lo=8, hi=14, seed=1):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab,
                             size=int(rng.integers(lo, hi))).tolist())
            for i in range(n)]


def _port(setup, requests, max_new, chaos=None, **kw):
    b = Batcher(setup[3], setup[4],
                ServeConfig(**{**BASE, "dtype": torch.float32, **kw}),
                chaos=ChaosInjector(**chaos) if chaos is not None else None)
    for rid, p in requests:
        b.submit(rid, p)
    b.run(max_new=max_new)
    return b


def _jax(setup, requests, max_new, chaos=None, **kw):
    b = JaxBatcher(setup[1], setup[2],
                   JaxServeConfig(**{**BASE, "dtype": jnp.float32, **kw}),
                   chaos=JaxChaos(**chaos) if chaos is not None else None)
    for rid, p in requests:
        b.submit(rid, p)
    b.run(max_new=max_new)
    return b


CHAOS = dict(exhaust_at={2: 0}, release_at=(5,), check_invariants=True)


@pytest.fixture(scope="module")
def chaos_run(setup):
    """The spec's traced chaos run on the port: exhaustion at round 2,
    release at round 5, so it preempts."""
    b = _port(setup, _requests(setup[0]), 10, chaos=CHAOS, telemetry=True)
    return b.results, b


def _spec_batcher(setup, telemetry=True):
    cfg = setup[0]
    b = Batcher(setup[3], setup[4], ServeConfig(
        max_len=96, batch=4, dtype=torch.float32, sync_every=4, paged=True,
        page_size=8, speculate_k=3, telemetry=telemetry))
    tok = int(np.random.default_rng(0).integers(0, cfg.vocab))
    for rid in range(3):
        b.submit(rid, [tok] * 12)
    b.run(max_new=12)
    return b


@pytest.fixture(scope="module")
def spec_run(setup):
    return _spec_batcher(setup)


# ---------------------------------------------------------------------------
# the Tracer against JAX's, on seeded sequences with an injected clock
# ---------------------------------------------------------------------------

def test_trace_constants_match_jax():
    for name in ("LIFECYCLE_KINDS", "CONTROL_KINDS", "CHAOS_KINDS", "_PID",
                 "_TID_SCHED", "_TID_QUEUE", "_TID_SLOT0"):
        assert getattr(ttel, name) == getattr(jtel, name), name
    assert tattr.TTFT_COMPONENTS == jattr.TTFT_COMPONENTS
    assert tattr.TPOT_COMPONENTS == jattr.TPOT_COMPONENTS


def _record(mod, seed: int, ring=None):
    """A seeded stream of events (queue- and slot-side, scheduler
    instants), spans and pool samples into one package's tracer, on a
    clock that advances a seeded step a call."""
    rng = np.random.default_rng(seed)
    steps = iter(np.cumsum(rng.uniform(1e-4, 2e-2, 4096)).tolist())
    tr = mod.Tracer(clock=lambda: next(steps), ring=ring)
    kinds = mod.LIFECYCLE_KINDS + mod.CONTROL_KINDS + mod.CHAOS_KINDS
    for r in range(60):
        what = rng.integers(0, 4)
        if what == 0:
            tr.add_span(str(rng.choice(["join", "decode-segment",
                                        "collect", "chaos"])), r,
                        tr.now(), tr.now())
        elif what == 1:
            tr.pool_gauge({k: int(v) for k, v in zip(
                ("free", "mapped", "cached", "preempted", "held"),
                rng.integers(0, 9, 5))})
        else:
            kind = str(rng.choice(kinds))
            rid = None if kind.startswith(("CHAOS", "DEGRADE",
                                           "WATCHDOG")) \
                else int(rng.integers(0, 6))
            slot = (None if rid is None or kind == "SUBMIT"
                    else int(rng.integers(0, 4)))
            tr.event(kind, rid, round=r, slot=slot,
                     pages_held=int(rng.integers(0, 5)),
                     pool_free=int(rng.integers(0, 9)),
                     reason="deadline" if kind == "CANCEL" else None)
    with tr.span("collect", round=61):
        pass
    return tr


def _perfetto(tr) -> dict:
    data = tr.to_perfetto()
    for e in data["traceEvents"]:
        if e.get("name") == "process_name":
            e["args"] = {"name": "(process)"}
    return data


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracer_matches_jax_on_seeded_sequences(seed, tmp_path):
    tr, jtr = _record(ttel, seed), _record(jtel, seed)
    assert list(tr.events) == list(jtr.events)
    assert list(tr.spans) == list(jtr.spans)
    assert list(tr.pool_samples) == list(jtr.pool_samples)
    assert tr.rids() == jtr.rids()
    assert tr.timelines() == jtr.timelines()
    assert tr.tail() == jtr.tail()
    assert _perfetto(tr) == _perfetto(jtr)
    path = tmp_path / "trace.json"
    data = tr.to_perfetto(str(path))
    assert json.loads(path.read_text()) == data
    names = [e for e in data["traceEvents"] if e.get("name") ==
             "process_name"]
    assert names[0]["args"]["name"] == "repro_torch.serve"


@pytest.mark.parametrize("ring", [1, 7, 64])
def test_tracer_ring_matches_jax(ring):
    tr, jtr = _record(ttel, 5, ring=ring), _record(jtel, 5, ring=ring)
    assert tr.tail() == jtr.tail()
    assert len(tr.tail()) <= ring
    assert _perfetto(tr) == _perfetto(jtr)


def test_tracer_timeline_sorted_and_copied():
    clock = iter(float(i) for i in range(100))
    tr = Tracer(clock=lambda: next(clock))
    tr.event("SUBMIT", 1, round=0)
    tr.event("ADMIT", 1, round=1, slot=0)
    tr.event("SUBMIT", 2, round=1)
    tl = tr.timeline(1)
    assert [e["kind"] for e in tl] == ["SUBMIT", "ADMIT"]
    tl[0]["kind"] = "corrupted"
    assert tr.events[0]["kind"] == "SUBMIT"
    assert tr.rids() == [1, 2]


def test_tracer_span_contextmanager():
    ts = iter([0.0, 1.0, 3.0])
    tr = Tracer(clock=lambda: next(ts))
    with tr.span("join", round=4):
        pass
    (sp,) = tr.spans
    assert sp == {"name": "join", "round": 4, "t0": 1.0, "t1": 3.0}


def test_tracer_ring_mode_keeps_tail():
    tr = Tracer(ring=3)
    for i in range(10):
        tr.event("SUBMIT", i, round=i)
    tail = tr.tail()
    assert [e["rid"] for e in tail] == [7, 8, 9]


# ---------------------------------------------------------------------------
# attribution against JAX's, on seeded lifecycles
# ---------------------------------------------------------------------------

def _lifecycles(mod, seed: int):
    """Seeded request lifecycles (queueing, chunked prefill, preemption
    with recompute, speculative commits, retirement or cancellation) with
    join and decode-segment spans, into one package's tracer."""
    rng = np.random.default_rng(seed)
    tr = mod.Tracer(clock=lambda: 0.0)
    t = 0.0
    for rid in range(8):
        t0 = t
        tr.event("SUBMIT", rid, t=t, round=0)
        rnd, slot = 0, rid % 4
        for admission in range(int(rng.integers(1, 3))):
            t += float(rng.uniform(0.001, 0.05))
            rnd += 1
            tr.event("ADMIT", rid, t=t, round=rnd, slot=slot)
            for _ in range(int(rng.integers(1, 3))):
                rnd += 1
                j0 = t + float(rng.uniform(0, 0.01))
                j1 = j0 + float(rng.uniform(0.001, 0.03))
                tr.add_span("join", rnd, j0, j1)
                tr.event("PREFILL_CHUNK", rid, t=j0, round=rnd, slot=slot,
                         recompute=admission > 0)
                t = j1
            if admission == 0:
                tr.event("FIRST_TOKEN", rid, t=t, round=rnd, slot=slot,
                         ttft_s=t - t0)
                t_ft = t
            for _ in range(int(rng.integers(1, 4))):
                rnd += 1
                s0 = t + float(rng.uniform(0, 0.005))
                s1 = s0 + float(rng.uniform(0.002, 0.02))
                tr.add_span("decode-segment", rnd, s0, s1)
                tr.event("SPEC_COMMIT", rid, t=s1, round=rnd, slot=slot,
                         committed=int(rng.integers(1, 4)), proposed=3)
                t = s1
            if admission == 0 and rng.random() < 0.5:
                t += 0.002
                tr.event("PREEMPT", rid, t=t, round=rnd, slot=slot)
                slot = (slot + 1) % 4
        tokens = int(rng.integers(2, 12))
        if rng.random() < 0.25:
            tr.event("CANCEL", rid, t=t, round=rnd, slot=slot,
                     reason=str(rng.choice(["deadline", "shed"])))
        else:
            tr.event("RETIRE", rid, t=t, round=rnd, slot=slot,
                     tokens=tokens, tpot_s=(t - t_ft) / (tokens - 1))
        t = t0 + float(rng.uniform(0.0, 0.02))
    return tr


def _close(a, b) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float):
        assert abs(a - b) <= ATTR_TOL, (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_attribution_matches_jax_on_seeded_lifecycles(seed):
    tr, jtr = _lifecycles(ttel, seed), _lifecycles(jtel, seed)
    for rid in tr.rids() + [99]:
        got, want = tattr.explain(tr, rid), jattr.explain(jtr, rid)
        assert (got is None) == (want is None)
        if got is None:
            continue
        _close({**got.ttft, **{f"tpot.{k}": v for k, v in got.tpot.items()},
                "ttft_s": got.ttft_s, "tpot_s": got.tpot_s},
               {**want.ttft, **{f"tpot.{k}": v
                                for k, v in want.tpot.items()},
                "ttft_s": want.ttft_s, "tpot_s": want.tpot_s})
        assert (got.rid, got.tokens, got.preemptions, got.cancelled) == (
            want.rid, want.tokens, want.preemptions, want.cancelled)
        got.check()
    _close(tattr.attribution_report(tr), jattr.attribution_report(jtr))


def test_attribution_report_empty_tracer():
    rep = attribution_report(Tracer())
    assert rep == jattr.attribution_report(jtel.Tracer())
    assert rep["requests"] == 0 and rep["per_request"] == []
    assert rep["dominant_ttft_component"] is None


# ---------------------------------------------------------------------------
# the traced batcher against JAX's traced batcher
# ---------------------------------------------------------------------------

def _plain_events(tracer) -> dict:
    return {rid: [{k: v for k, v in e.items() if k not in HOST_TIMES}
                  for e in tracer.timeline(rid)]
            for rid in tracer.rids()}


def _system_requests(cfg):
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab, size=16).tolist()
    return [(i, system + rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 30))).tolist())
        for i in range(6)]


TRAFFIC = {
    "plain": (dict(admission_mode="reserve", total_pages=24), None, 10),
    "preempting": ({}, CHAOS, 10),
    "chunked": (dict(prefill_chunk=8, prefix_cache=True, total_pages=24),
                None, 8),
    "speculative": (dict(speculate_k=3, total_pages=24), None, 12),
}


@pytest.mark.parametrize("name", list(TRAFFIC))
def test_traced_batcher_matches_jax(setup, name):
    """Per rid: JAX's event kinds, rounds, slots and attributes, and its
    non-event scheduler instants; tokens equal to an untraced run."""
    kw, chaos, max_new = TRAFFIC[name]
    cfg = setup[0]
    requests = (_system_requests(cfg) if name == "chunked"
                else _requests(cfg, n=6))
    if name == "speculative":
        tok = int(np.random.default_rng(0).integers(0, cfg.vocab))
        requests = [(rid, [tok] * 12) for rid in range(4)]
    tb = _port(setup, requests, max_new, chaos=chaos, telemetry=True, **kw)
    jb = _jax(setup, requests, max_new, chaos=chaos, telemetry=True, **kw)
    off = _port(setup, requests, max_new, chaos=chaos, **kw)
    assert tb.results == jb.results == off.results
    assert _plain_events(tb.telemetry) == _plain_events(jb.telemetry)
    sched = [[{k: v for k, v in e.items() if k not in HOST_TIMES}
              for e in b.telemetry.events if e["rid"] is None]
             for b in (tb, jb)]
    assert sched[0] == sched[1]
    assert ([(s["name"], s["round"]) for s in tb.telemetry.spans]
            == [(s["name"], s["round"]) for s in jb.telemetry.spans])
    assert ([c for _, c in tb.telemetry.pool_samples]
            == [c for _, c in jb.telemetry.pool_samples])
    assert off.telemetry is None
    if name == "preempting":
        assert tb.preemptions > 0
    if name == "speculative":
        assert tb.metrics.value("spec.steps") > 0
    if name == "chunked":
        assert tb.chunk_joins > 0 and tb.prefix_stats()["hits"] > 0


# ---------------------------------------------------------------------------
# the spec cases of tests/test_telemetry.py on the port's batcher
# ---------------------------------------------------------------------------

def test_trace_complete_lifecycles(chaos_run):
    results, b = chaos_run
    tr = b.telemetry
    assert set(tr.rids()) == set(results)
    for rid in tr.rids():
        kinds = [e["kind"] for e in tr.timeline(rid)]
        assert kinds[0] == "SUBMIT" and kinds[-1] == "RETIRE"
        assert kinds.count("RETIRE") == 1 and "FIRST_TOKEN" in kinds
        rounds = [e["round"] for e in tr.timeline(rid)]
        assert rounds == sorted(rounds)
        for e in tr.timeline(rid):
            assert e["kind"] in LIFECYCLE_KINDS
            assert e["pool_free"] >= 0 and e["pages_held"] >= 0


def test_trace_preempt_resume_pairs(chaos_run):
    _, b = chaos_run
    tr = b.telemetry
    assert b.preemptions > 0
    total = 0
    for rid in tr.rids():
        kinds = [e["kind"] for e in tr.timeline(rid)]
        total += kinds.count("PREEMPT")
        for i, k in enumerate(kinds):
            if k == "PREEMPT":
                rest = kinds[i + 1:]
                assert "ADMIT" in rest and "RESUME" in rest
                assert rest.index("ADMIT") < rest.index("RESUME")
        admits = [e for e in tr.timeline(rid) if e["kind"] == "ADMIT"]
        preempts = [e for e in tr.timeline(rid) if e["kind"] == "PREEMPT"]
        assert len(admits) == 1 + len(preempts)
        assert all(e["slot"] is not None for e in admits + preempts)
        assert all(e["prior_tokens"] >= 0 for e in tr.timeline(rid)
                   if e["kind"] == "RESUME")
    assert total == b.preemptions


def test_chaos_faults_land_in_trace(chaos_run):
    _, b = chaos_run
    kinds = {e["kind"] for e in b.telemetry.events if e["rid"] is None}
    assert {"CHAOS_HOLD", "CHAOS_RELEASE_HELD"} <= kinds
    assert kinds <= set(CHAOS_KINDS)
    hold = next(e for e in b.telemetry.events if e["kind"] == "CHAOS_HOLD")
    assert hold["round"] == 2 and hold["pages"] >= 0
    assert hold["keep_free"] == 0


def test_pool_gauge_sampled(chaos_run):
    _, b = chaos_run
    tr = b.telemetry
    assert tr.pool_samples
    for _, counts in tr.pool_samples:
        assert set(counts) == {"free", "mapped", "cached", "preempted",
                               "held"}
        assert sum(counts.values()) == b.pool.n_pages
    assert (b.metrics.gauge("pool.free_pages")
            == tr.pool_samples[-1][1]["free"])


def test_scheduler_spans_per_round(chaos_run):
    _, b = chaos_run
    names = {sp["name"] for sp in b.telemetry.spans}
    assert {"join", "decode-segment", "collect", "chaos"} <= names
    assert all(sp["t1"] >= sp["t0"] for sp in b.telemetry.spans)


def test_perfetto_schema_valid(chaos_run, tmp_path):
    _, b = chaos_run
    path = tmp_path / "trace.json"
    data = b.telemetry.to_perfetto(str(path))
    loaded = json.loads(path.read_text())
    assert loaded == data
    evs = loaded["traceEvents"]
    assert evs and loaded["displayTimeUnit"] == "ms"
    for e in evs:
        assert e["ph"] in {"M", "X", "i", "C", "b", "e"} and e["pid"] == 1
        if e["ph"] != "M":
            assert isinstance(e["ts"], float) and e["ts"] >= 0.0
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
        if e["ph"] == "i":
            assert e["s"] in ("t", "p", "g")
        if e["ph"] in ("b", "e"):
            assert "id" in e
    used = {e["tid"] for e in evs if "tid" in e and e["ph"] != "M"}
    named = {e["tid"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert used <= named


def _slot_spans(b):
    return [e for e in b.telemetry.to_perfetto()["traceEvents"]
            if e["ph"] == "X" and e.get("cat") == "slot"]


def test_perfetto_slot_spans_never_overlap(chaos_run):
    by_tid: dict = {}
    for e in _slot_spans(chaos_run[1]):
        by_tid.setdefault(e["tid"], []).append(e)
    assert by_tid
    for spans in by_tid.values():
        spans.sort(key=lambda e: e["ts"])
        for a, b in zip(spans, spans[1:]):
            assert a["ts"] + a["dur"] <= b["ts"] + 1e-6


def test_perfetto_preempted_span_ends_with_preempt(chaos_run):
    spans = _slot_spans(chaos_run[1])
    assert {"PREEMPT", "RETIRE"} <= {e["args"]["end"] for e in spans}
    pre = next(e for e in spans if e["args"]["end"] == "PREEMPT")
    later = [e for e in spans if e["args"]["rid"] == pre["args"]["rid"]
             and e["ts"] >= pre["ts"] + pre["dur"]]
    assert later and any(e["args"]["end"] == "RETIRE" for e in later)


def test_perfetto_queue_spans_balanced(chaos_run):
    evs = chaos_run[1].telemetry.to_perfetto()["traceEvents"]
    opens = [e["id"] for e in evs if e["ph"] == "b"]
    assert opens and sorted(opens) == sorted(e["id"] for e in evs
                                             if e["ph"] == "e")


def test_perfetto_spec_commits_on_slot_tracks(spec_run):
    b = spec_run
    commits = [e for e in b.telemetry.events if e["kind"] == "SPEC_COMMIT"]
    assert commits
    marks = [e for e in b.telemetry.to_perfetto()["traceEvents"]
             if e["ph"] == "i" and e["name"] == "SPEC_COMMIT"]
    assert len(marks) == len(commits)
    for e in marks:
        assert e["tid"] == ttel._TID_SLOT0 + e["args"]["slot"]
        assert e["args"]["accepted_drafts"] >= 0
        assert e["args"]["committed"] >= 1
    for rid in range(3):
        kinds = [e["kind"] for e in b.telemetry.timeline(rid)]
        assert kinds.index("FIRST_TOKEN") < kinds.index("SPEC_COMMIT")


def test_metrics_match_legacy_stats(chaos_run):
    _, b = chaos_run
    m = b.metrics
    lat = b.latency_stats()
    assert lat["ttft_p50_s"] == _pct(m.samples("lat.ttft_s"), 50)
    assert lat["tpot_p50_s"] == m.percentile("lat.tpot_s", 50)
    assert lat["queue_wait_p95_s"] == m.percentile("lat.queue_wait_s", 95)
    assert lat["preemptions"] == m.value("preempt.count") == b.preemptions
    assert b.join_stats()["joins"] == m.count("join.seconds")
    assert b.join_stats()["max_join_s"] == max(m.samples("join.seconds"))
    assert (b.prefix_stats()["prefill_computed"]
            == m.value("prefill.computed_tokens"))


def test_spec_metrics_match_legacy(spec_run):
    b = spec_run
    m = b.metrics
    assert m.value("spec.steps") > 0
    assert b.spec_stats()["acceptance_rate"] == pytest.approx(
        m.value("spec.accepted") / max(1, m.value("spec.proposed")))
    commits = [e for e in b.telemetry.events if e["kind"] == "SPEC_COMMIT"]
    assert len(commits) == m.value("spec.steps")
    assert sum(e["committed"] for e in commits) == m.value("spec.emitted")
    assert (sum(e["accepted_drafts"] for e in commits)
            == m.value("spec.accepted"))


def test_reset_stats_clears_everything(setup):
    b = _port(setup, _requests(setup[0]), 10, chaos=CHAOS, telemetry=True)
    lists = ("lat.ttft_s", "lat.tpot_s", "lat.queue_wait_s", "join.seconds")
    assert b.preemptions > 0 and all(b.metrics.samples(k) for k in lists)
    b.reset_stats()
    assert all(b.metrics.samples(k) == [] for k in lists)
    assert b.kv_samples == [] and b.preemptions == 0
    assert (b.prefill_computed == b.metrics.value("spec.steps")
            == b.chunk_joins == 0)
    assert not b._first_tok_t and b.preempt_events == []
    assert b.join_stats()["joins"] == 0
    # the pool gauges are seeded again from the live pool
    assert b.metrics.gauge("pool.free_pages", -1) == b.pool.free_pages


def test_telemetry_off_by_default(setup):
    b = _port(setup, _requests(setup[0], n=2), 4)
    assert b.telemetry is None and b.pool.gauge_cb is None
    assert b.flight is not None
    assert all(len(v) == 4 for v in b.results.values())
    assert b.metrics.count("lat.ttft_s") == 2


def test_traced_equals_untraced_tokens(setup, chaos_run):
    off = _port(setup, _requests(setup[0]), 10, chaos=CHAOS)
    assert off.results == chaos_run[0]


# ---------------------------------------------------------------------------
# the spec cases of tests/test_attribution.py on the port's batcher
# ---------------------------------------------------------------------------

def test_explain_components_sum_to_measured(chaos_run):
    results, b = chaos_run
    for rid in results:
        a = explain(b.telemetry, rid)
        a.check(tol=1e-6)
        assert set(a.ttft) == set(TTFT_COMPONENTS)
        assert set(a.tpot) == set(TPOT_COMPONENTS)
        for comp, v in {**a.ttft, **a.tpot}.items():
            assert v >= -1e-9, (rid, comp, v)
    assert explain(b.telemetry, 999_999) is None


def test_explain_preempted_request_pays_recompute(chaos_run):
    _, b = chaos_run
    preempted = {e["rid"] for e in b.telemetry.events
                 if e["kind"] == "PREEMPT"}
    costs = []
    for rid in preempted:
        a = explain(b.telemetry, rid)
        assert a.preemptions >= 1
        costs.append(a.ttft["queue_wait_s"] + a.ttft["preempt_recompute_s"]
                     + a.tpot["preempt_recompute_s"] + a.tpot["requeue_s"])
    assert preempted and max(costs) > 0.0


def test_explain_spec_run_carves_verify_overhead(spec_run):
    for rid in spec_run.results:
        a = explain(spec_run.telemetry, rid)
        a.check(tol=1e-6)
        assert a.tpot["verify_overhead_s"] >= 0.0
        assert (a.tpot["verify_overhead_s"] + a.tpot["decode_segment_s"]
                <= a.decode_s + 1e-9)


def test_attribution_report_shape_and_shares(chaos_run):
    results, b = chaos_run
    rep = attribution_report(b.telemetry)
    assert rep["requests"] == len(results)
    for section, comps in (("ttft", TTFT_COMPONENTS),
                           ("tpot", TPOT_COMPONENTS)):
        assert set(rep[section]) == set(comps)
        assert sum(rep[section][c]["share"] for c in comps) == \
            pytest.approx(1.0, abs=1e-6)
    dom = rep["dominant_ttft_component"]
    assert all(rep["ttft"][dom]["total_s"] >= rep["ttft"][c]["total_s"]
               for c in TTFT_COMPONENTS)
    ttfts = [r["ttft_s"] for r in rep["per_request"]]
    assert ttfts == sorted(ttfts, reverse=True)
    json.dumps(rep)


def _slo_run(setup, **slo_kw):
    b = Batcher(setup[3], setup[4],
                ServeConfig(**{**BASE, "dtype": torch.float32, **slo_kw}))
    for (rid, p), prio in zip(_requests(setup[0], n=4), (0, 0, 1, 1)):
        b.submit(rid, p, priority=prio)
    b.run(max_new=6)
    return b


def test_slo_disabled_is_vacuous(chaos_run):
    s = chaos_run[1].slo_stats()
    assert s["enabled"] is False and s["slo_attainment"] == 1.0
    assert s["classes"] == {}


def test_slo_generous_attains_everything(setup):
    s = _slo_run(setup, ttft_slo_s=3600.0, tpot_slo_s=3600.0).slo_stats()
    assert s["enabled"] is True and s["slo_attainment"] == 1.0
    assert set(s["classes"]) == {0, 1}
    assert all(c["ttft_attainment"] == 1.0 and c["ttft_total"] > 0
               for c in s["classes"].values())
    assert s["burn_rate_ttft"] == s["burn_rate_tpot"] == 0.0


def test_slo_unmeetable_attains_nothing(setup):
    s = _slo_run(setup, ttft_slo_s=1e-12, tpot_slo_s=1e-12,
                 slo_target=0.9).slo_stats()
    assert s["slo_attainment"] == 0.0
    assert s["burn_rate_ttft"] == pytest.approx(10.0)


def test_slo_counters_survive_in_registry(setup):
    b = _slo_run(setup, ttft_slo_s=3600.0)
    total = sum(b.metrics.value(f"slo.ttft_total.c{c}") for c in (0, 1))
    assert total == b.metrics.count("lat.ttft_s") == 4


class _PoolFault(ChaosInjector):
    """Raise a real allocator PageError at the first live round >= at."""

    def __init__(self, at=2):
        super().__init__()
        self.at, self.fired = at, False

    def on_round(self, b):
        super().on_round(b)
        if not self.fired and b.round >= self.at:
            live = [i for i, rid in enumerate(b.slot_rid) if rid is not None]
            if live:
                self.fired = True
                b.pool.reserve(live[0], 1)


def _crash_run(setup, tmp_path=None, **kw):
    path = str(tmp_path / "bundle.json") if tmp_path is not None else None
    b = Batcher(setup[3], setup[4], ServeConfig(
        **{**BASE, "dtype": torch.float32}, flight_path=path, **kw),
        chaos=_PoolFault())
    for rid, p in _requests(setup[0], n=3):
        b.submit(rid, p)
    with pytest.raises(PageError):
        b.run(max_new=6)
    return b, path


def test_flight_bundle_on_page_error(setup, tmp_path):
    b, path = _crash_run(setup, tmp_path)
    bundle = b.last_flight_bundle
    assert bundle["schema"] == 1 and "PageError" in bundle["error"]
    assert bundle["events"]
    assert all(e["round"] <= bundle["round"] for e in bundle["events"])
    pool = bundle["pool"]
    assert (len(pool["free"]) + len(pool["cached"]) + len(pool["preempted"])
            + len(pool["held"]) + sum(len(p) for p in pool["slot_pages"])
            == pool["n_pages"])
    assert len(bundle["slot_table"]["slot_rid"]) == BASE["batch"]
    with open(path) as f:
        disk = json.load(f)
    assert (disk["error"], disk["round"]) == (bundle["error"],
                                              bundle["round"])
    assert disk["config"]["dtype"] == "torch.float32"
    json.dumps(bundle)


def test_flight_recorder_ring_is_bounded(setup, tmp_path):
    b, _ = _crash_run(setup, tmp_path, flight_events=4)
    assert len(b.last_flight_bundle["events"]) <= 4


def test_flight_recorder_opt_out(setup):
    b, _ = _crash_run(setup, flight_recorder=False)
    assert b.flight is None and b.last_flight_bundle is None
