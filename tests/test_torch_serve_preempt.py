"""Optimistic admission, page-level preemption with recompute-on-resume
and the chaos injector in the port, against the JAX ``Batcher`` on the
same float32 weights at qwen2-0.5b ``reduced()``: the deterministic cases
of ``tests/test_serve_preempt.py`` (its hybrid-SSM refusal waits for the
port's SSM model, and its hypothesis stress test is matched by a
port-only one here).

Each preempting case gives JAX's results, admission order,
``preempt_stats()`` (events included), ``kv_utilization()``, chaos
events and prefix, chunk and speculation counters, or a stream that
differs at a shown logit near-tie (1e-4); each actually preempts, and
gives the port's own no-preemption reference (reserve admission on an
ample pool).  The victim policy is held on staged slot tables, and the
configuration checks match JAX's, message for message."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve.chaos import ChaosInjector as JaxChaos
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Batcher as JaxBatcher
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import forward, logits_fn
from repro_torch.serve.chaos import ChaosInjector
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Batcher
from repro_torch.serve.telemetry import _pct

torch.set_num_threads(1)

NEAR_TIE = 1e-4
BASE = dict(max_len=96, batch=6, sync_every=4, paged=True, page_size=8,
            total_pages=10, admission_mode="optimistic")


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-0.5b").reduced()
    jmodel = JaxModel(jax_get_config("qwen2-0.5b").reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), tparams


@pytest.fixture(scope="module")
def reference(setup):
    """The port's no-preemption oracle (reserve admission over an ample
    pool), one run per request set and budget."""
    cache = {}

    def ref(requests, max_new=14):
        key = (tuple((rid, tuple(p)) for rid, p in requests), max_new)
        if key not in cache:
            cache[key] = _port(setup, requests, max_new=max_new,
                               admission_mode="reserve",
                               total_pages=64).results
        return cache[key]
    return ref


def _port(setup, requests, max_new=14, chaos=None, priorities=None, **kw):
    _, _, _, model, tparams = setup
    b = Batcher(model, tparams,
                ServeConfig(**{**BASE, "dtype": torch.float32, **kw}),
                chaos=chaos)
    for rid, p in requests:
        b.submit(rid, p, priority=(priorities or {}).get(rid, 0))
    b.run(max_new=max_new)
    return b


def _jax(setup, requests, max_new=14, chaos=None, priorities=None, **kw):
    _, jmodel, jparams, _, _ = setup
    b = JaxBatcher(jmodel, jparams,
                   JaxServeConfig(**{**BASE, "dtype": jnp.float32, **kw}),
                   chaos=chaos)
    for rid, p in requests:
        b.submit(rid, p, priority=(priorities or {}).get(rid, 0))
    b.run(max_new=max_new)
    return b


def _requests(cfg, n=9, lo=8, hi=14, seed=1):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab,
                             size=int(rng.integers(lo, hi))).tolist())
            for i in range(n)]


def _system_requests(cfg):
    """A 16-token system prompt before 4-9 private tokens."""
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab, size=16).tolist()
    return [(i, system + rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 10))).tolist())
        for i in range(8)]


def _repeat_requests(cfg):
    """Runs of one token, so the drafter's drafts are accepted."""
    rng = np.random.default_rng(6)
    tok = int(rng.integers(0, cfg.vocab))
    return [(i, [tok] * int(rng.integers(8, 14))) for i in range(8)]


def _same_or_near_tie(setup, prompt, got, want):
    """Equal streams (True), or a first difference at a near-tie of the
    port's float32 logits after the common prefix (False); else fail."""
    cfg, tparams = setup[0], setup[4]
    if got == want:
        return True
    diff = [j for j in range(min(len(got), len(want))) if got[j] != want[j]]
    assert diff, ("equal prefix, different lengths", got, want)
    i = diff[0]
    hidden, _ = forward(tparams, {"tokens": torch.tensor([prompt + got[:i]])},
                        cfg, dtype=torch.float32)
    logits = logits_fn(tparams, hidden[:, -1:], cfg)[0, 0]
    gap = abs(float(logits[got[i]] - logits[want[i]]))
    assert gap < NEAR_TIE, (f"streams differ at token {i} without a "
                            f"near-tie (gap {gap})", got, want)
    return False


def _assert_same_streams(setup, requests, got, want):
    for rid, p in requests:
        _same_or_near_tie(setup, p, got[rid], want[rid])


def _assert_matches_jax(setup, requests, jb, tb):
    """JAX's results and schedule: admission order, preemptions (events
    included), KV samples, chaos events, prefix, chunk and speculation
    counters.  Where a stream differs at a near-tie, only the streams are
    compared."""
    prompts = dict(requests)
    equal = all([_same_or_near_tie(setup, prompts[rid], tb.results[rid],
                                   jb.results[rid]) for rid in prompts])
    assert set(tb.results) == set(jb.results) == set(prompts)
    if not equal:
        return
    assert tb.admit_order == jb.admit_order
    assert tb.preempt_stats() == jb.preempt_stats()
    assert tb.preempted_rids == jb.preempted_rids
    assert tb.kv_samples == jb.kv_samples
    assert tb.kv_utilization() == jb.kv_utilization()
    assert tb.prefix_stats() == jb.prefix_stats()
    assert tb.spec_stats() == jb.spec_stats()
    tj, jj = tb.join_stats(), jb.join_stats()
    for key in ("joins", "chunk_joins", "budget_deferrals"):
        assert tj[key] == jj[key], key
    assert tb.round == jb.round
    if jb.chaos is not None:
        assert tb.chaos.events == jb.chaos.events
        assert tb.chaos.slot_failures == jb.chaos.slot_failures


def _assert_drained(b):
    assert b.pool.used_pages == 0
    assert int(b.pool.refcount.sum()) == 0
    b.pool.check()
    if b.prefix is not None:
        b.prefix.check()


# ---------------------------------------------------------------------------
# configuration checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,chaos", [
    (dict(admission_mode="eager"), False),
    (dict(admission_mode="optimistic"), False),
    ({}, True),
], ids=["unknown-mode", "optimistic-unpaged", "chaos-unpaged"])
def test_preempt_validation_matches_jax(setup, kw, chaos):
    _, jmodel, jparams, model, tparams = setup
    messages = []
    for make in (lambda: JaxBatcher(jmodel, jparams, JaxServeConfig(
                     max_len=32, batch=2, **kw),
                     chaos=JaxChaos() if chaos else None),
                 lambda: Batcher(model, tparams, ServeConfig(
                     max_len=32, batch=2, **kw),
                     chaos=ChaosInjector() if chaos else None)):
        with pytest.raises(ValueError,
                           match="admission mode|paged|chaos") as err:
            make()
        messages.append(str(err.value))
    assert messages[1] == messages[0]


# ---------------------------------------------------------------------------
# the victim policy, on staged slot tables (no decode)
# ---------------------------------------------------------------------------

def _staged(setup, **kw):
    """A JAX and a port batcher over a 32-page pool, nothing run."""
    _, jmodel, jparams, model, tparams = setup
    cfg = {**BASE, "total_pages": 32, **kw}
    return (JaxBatcher(jmodel, jparams,
                       JaxServeConfig(**cfg, dtype=jnp.float32)),
            Batcher(model, tparams, ServeConfig(**cfg, dtype=torch.float32)))


def _plant(b, slot, rid, tokens, outputs=0, priority=0, pending=False):
    """Reserve pages by hand and plant the host bookkeeping the victim
    policy reads (the same attributes in both packages)."""
    b.pool.reserve(slot, tokens)
    b.slot_rid[slot] = rid
    b.slot_prompt[slot] = list(range(tokens))
    b.slot_len[slot] = tokens
    b.slot_filled[slot] = tokens
    b.slot_max_tokens[slot] = tokens + 16
    b.req_priority[rid] = priority
    if pending:
        b.slot_pending[slot] = [0] * 4
    if outputs:
        b.outputs[rid] = list(range(outputs))


def _evict(b, slot):
    b.pool.release(slot)
    b.slot_rid[slot] = None


def test_victim_lowest_priority_first(setup):
    for b in _staged(setup):
        _plant(b, 0, 10, tokens=32, outputs=1, priority=2)
        _plant(b, 1, 11, tokens=32, outputs=1, priority=0)
        _plant(b, 2, 12, tokens=32, outputs=1, priority=1)
        assert b._pick_victim() == 1


def test_victim_tiebreak_most_pages_then_least_progress(setup):
    for b in _staged(setup):
        _plant(b, 0, 10, tokens=16, outputs=1)       # 2 pages
        _plant(b, 1, 11, tokens=32, outputs=5)       # 4 pages, progress 5
        _plant(b, 2, 12, tokens=32, outputs=1)       # 4 pages, progress 1
        assert b._pick_victim() == 2
        _evict(b, 2)
        assert b._pick_victim() == 1


def test_victim_prefilling_counts_as_zero_progress(setup):
    for b in _staged(setup):
        _plant(b, 0, 10, tokens=32, outputs=3)
        _plant(b, 1, 11, tokens=32, pending=True)
        assert b._pick_victim() == 1


def test_victim_slot_id_breaks_final_tie(setup):
    for b in _staged(setup):
        _plant(b, 2, 12, tokens=16, outputs=2)
        _plant(b, 4, 14, tokens=16, outputs=2)
        assert b._pick_victim() == 2


def test_victim_barrier_protection_orders_last(setup):
    """A request preempted ``admission_max_skips`` times is picked only
    when nothing unprotected is left."""
    for b in _staged(setup, admission_max_skips=2):
        _plant(b, 0, 10, tokens=32, outputs=1)
        _plant(b, 1, 11, tokens=16, outputs=5)
        b._preempt_counts[10] = 2
        assert b._pick_victim() == 1
        _evict(b, 1)
        assert b._pick_victim() == 0


def test_chaos_victim_override_wins_and_validates(setup):
    jb, tb = _staged(setup)
    for b, make in ((jb, JaxChaos), (tb, ChaosInjector)):
        b.chaos = make(victim_override=lambda bat, cands: cands[-1])
        _plant(b, 0, 10, tokens=32, outputs=1)
        _plant(b, 1, 11, tokens=16, outputs=5)
        assert b._pick_victim() == 1
        assert b.chaos.events[-1][1] == "victim_override"
    assert tb.chaos.events == jb.chaos.events
    messages = []
    for b, make in ((jb, JaxChaos), (tb, ChaosInjector)):
        b.chaos = make(victim_override=lambda bat, cands: 5)
        with pytest.raises(ValueError, match="not in candidates") as err:
            b._pick_victim()
        messages.append(str(err.value))
    assert messages[1] == messages[0]


# ---------------------------------------------------------------------------
# overload -> preemption -> resume, against JAX and the port's reference
# ---------------------------------------------------------------------------

def _check_base(b):
    s = b.preempt_stats()
    assert s["recomputed_ok"] and b.preempted_token_recompute > 0


def _check_priority(b):
    assert 3 not in b.preempted_rids


def _check_barrier(b):
    assert b.preempt_stats()["recomputed_ok"]
    assert not b._resumed and not b._preempt_counts


def _check_exhaustion(b):
    kinds = {kind for _, kind, _ in b.chaos.events}
    assert {"hold", "release_held"} <= kinds
    assert b.pool.held_pages == 0


def _check_failure(b):
    assert b.chaos.slot_failures == 1
    assert b.preempt_stats()["slot_failures"] == 1
    assert b.preempt_stats()["recomputed_ok"]


def _check_failure_reserve(b):
    assert b.preemptions == 1


def _check_chunked(b):
    assert b.chunk_joins > 0


def _check_prefix(b):
    assert b.prefill_skipped > 0


def _check_spec(b):
    assert b.spec_stats()["steps"] > 0


# name: (request set, port/JAX config, chaos arguments, priorities, check)
CASES = {
    "overload": ("base", {}, None, None, _check_base),
    "priority": ("base", {}, None, {3: 1}, _check_priority),
    "barrier": ("base", dict(admission_max_skips=1), None, None,
                _check_barrier),
    "chaos-exhaustion": ("base", dict(total_pages=20),
                         dict(exhaust_at={2: 0}, release_at=(8,),
                              check_invariants=True), None,
                         _check_exhaustion),
    "slot-failure": ("n5", dict(total_pages=24),
                     dict(fail_slot_at={3: "deepest"},
                          check_invariants=True), None, _check_failure),
    "slot-failure-reserve": ("n4", dict(admission_mode="reserve",
                                        total_pages=24),
                             dict(fail_slot_at={2: "deepest"}), None,
                             _check_failure_reserve),
    "chunked": ("long", dict(prefill_chunk=8, total_pages=12), None, None,
                _check_chunked),
    "prefix": ("system", dict(prefix_cache=True, total_pages=12), None, None,
               _check_prefix),
    "spec": ("repeat", dict(speculate_k=2, total_pages=11), None, None,
             _check_spec),
}
REQUEST_SETS = {
    "base": lambda cfg: _requests(cfg),
    "n5": lambda cfg: _requests(cfg, n=5),
    "n4": lambda cfg: _requests(cfg, n=4),
    "long": lambda cfg: _requests(cfg, n=7, lo=20, hi=34, seed=3),
    "system": _system_requests,
    "repeat": _repeat_requests,
}


@pytest.mark.parametrize("case", list(CASES))
def test_preempting_run_matches_jax_and_reference(setup, reference, case):
    """Overload, a protected priority class, the barrier at
    ``admission_max_skips=1``, forced exhaustion, slot failure (optimistic
    and reserve), and preemption with chunked prefill, the prefix cache
    and speculation: JAX's results and schedule, real preemptions, the
    no-preemption streams and a drained pool."""
    which, kw, chaos, priorities, check = CASES[case]
    requests = REQUEST_SETS[which](setup[0])
    tb = _port(setup, requests, priorities=priorities,
               chaos=ChaosInjector(**chaos) if chaos else None, **kw)
    jb = _jax(setup, requests, priorities=priorities,
              chaos=JaxChaos(**chaos) if chaos else None, **kw)
    _assert_matches_jax(setup, requests, jb, tb)
    assert tb.preemptions > 0
    _assert_same_streams(setup, requests, tb.results, reference(requests))
    check(tb)
    _assert_drained(tb)


def test_optimistic_packs_more_than_reserve(setup, reference):
    """On the same 10-page pool, optimistic admission holds strictly more
    live slots at its peak and a higher mean KV utilization than reserve
    admission, and both give the reference's streams; the reserve run's
    KV samples are JAX's."""
    requests = _requests(setup[0])
    opt = _port(setup, requests)
    res = _port(setup, requests, admission_mode="reserve")
    jres = _jax(setup, requests, admission_mode="reserve")
    _assert_matches_jax(setup, requests, jres, res)
    _assert_same_streams(setup, requests, res.results, reference(requests))
    _assert_same_streams(setup, requests, opt.results, reference(requests))
    assert res.preemptions == 0
    u, r = opt.kv_utilization(), res.kv_utilization()
    assert u["peak_live_slots"] > r["peak_live_slots"]
    assert u["mean_util"] > r["mean_util"]


# ---------------------------------------------------------------------------
# latency and stats
# ---------------------------------------------------------------------------

def test_pct_guards_empty_lists():
    assert _pct([], 50) == 0.0
    assert _pct([2.0], 95) == 2.0


def test_latency_stats_report_queue_wait_and_preemptions(setup):
    """Every admission, re-admissions included, closes one queue-wait
    interval; the preemption counters are JAX's; ``reset_stats`` clears
    the wave's preemptions and keeps the in-flight bookkeeping."""
    requests = _requests(setup[0])
    tb, jb = _port(setup, requests), _jax(setup, requests)
    lat, jlat = tb.latency_stats(), jb.latency_stats()
    assert set(lat) == set(jlat)
    for key in ("requests", "preemptions", "preempted_token_recompute",
                "cancellations", "shed_requests", "deadline_total",
                "deadline_attainment", "watchdog_trips"):
        assert lat[key] == jlat[key], key
    assert lat["preemptions"] == tb.preemptions > 0
    assert lat["preempted_token_recompute"] > 0
    assert lat["queue_wait_p95_s"] >= lat["queue_wait_p50_s"] > 0.0
    assert tb.metrics.count("lat.queue_wait_s") == len(tb.admit_order)
    tb.reset_stats()
    jb.reset_stats()
    assert tb.latency_stats()["queue_wait_p50_s"] == 0.0
    assert tb.preempt_stats() == jb.preempt_stats()
    assert tb.preempt_stats()["preemptions"] == 0
    assert not tb.preempt_events and not tb.preempted_rids
    assert tb.round == jb.round > 0


# ---------------------------------------------------------------------------
# hypothesis: preemption x chunks x prefix x speculation, the port alone
# ---------------------------------------------------------------------------

@settings(max_examples=5, deadline=None, derandomize=True, database=None)
@given(st.data())
def test_stress_preemption_invariants(setup, reference, data):
    """Random overloaded traffic with chaos holds and per-round invariant
    checks, every feature drawn on or off: the port's no-preemption
    streams, every preempted request completed, nothing held, the pool
    drained."""
    cfg = setup[0]
    rng = np.random.default_rng(data.draw(st.integers(0, 2**16),
                                          label="seed"))
    n_req = data.draw(st.integers(4, 9), label="n_req")
    system = rng.integers(0, cfg.vocab,
                          size=data.draw(st.integers(0, 16),
                                         label="system")).tolist()
    requests = [(i, system + rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 14))).tolist())
        for i in range(n_req)]
    max_new = data.draw(st.integers(4, 14), label="max_new")
    kw: dict = {"total_pages": data.draw(st.integers(8, 14), label="pages")}
    if data.draw(st.booleans(), label="chunked?"):
        kw["prefill_chunk"] = 8
    if data.draw(st.booleans(), label="prefix?"):
        kw["prefix_cache"] = True
    if data.draw(st.booleans(), label="spec?"):
        kw["speculate_k"] = 2
    priorities = {i: data.draw(st.integers(0, 1), label=f"prio{i}")
                  for i in range(n_req)}
    chaos = ChaosInjector(
        exhaust_at={data.draw(st.integers(2, 5), label="xr"): 0},
        release_at=(data.draw(st.integers(7, 10), label="rr"),),
        check_invariants=True)
    b = _port(setup, requests, max_new=max_new, chaos=chaos,
              priorities=priorities, **kw)
    _assert_same_streams(setup, requests, b.results,
                         reference(requests, max_new))
    assert b.preempt_stats()["recomputed_ok"]
    assert not b._resumed
    assert b.pool.held_pages == 0
    _assert_drained(b)
