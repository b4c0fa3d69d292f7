"""The port's prefix cache against the JAX package's.

The radix tree alone: the port's ``PrefixCache`` over the port's
``KVPool`` and JAX's over JAX's take the same seeded operation sequences
(match, admit by share + extend or reserve, insert of the covered pages,
release with the registered pages cacheable, eviction, allocation under
pressure that evicts through ``pool.evictor``, ``check()``); after every
operation the results, the pools' ``snapshot()``, the trees (path, page
and LRU stamp of every node) and ``evicted_pages`` are equal.  The unit
cases of ``tests/test_prefixcache.py`` run on both and give the same
records.  The pages past the pool (the sentinel's and the sink) are
refused.

Serving: the port's ``Batcher`` against JAX's on the same float32
weights at qwen2-0.5b ``reduced()``, with the prefix cache on (the cases
of ``tests/test_serve_prefix.py``: mixed suffix lengths, refills that
re-hit the cache, EOS mid-batch, eviction in a tight pool and a hit in
the same refill round): equal results, admission order,
``prefix_stats()``, chunk counters and ``kv_utilization()``; or a stream
that differs at a shown logit near-tie (1e-4).  In the port, cache on
gives cache off's greedy streams; the configuration check matches
JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.kvpool import KVPool as JaxKVPool
from repro.serve.kvpool import PageError as JaxPageError
from repro.serve.prefixcache import PrefixCache as JaxPrefixCache
from repro.serve.scheduler import Batcher as JaxBatcher
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import forward, logits_fn
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.kvpool import KVPool, PageError
from repro_torch.serve.prefixcache import PrefixCache
from repro_torch.serve.scheduler import Batcher

torch.set_num_threads(1)

NEAR_TIE = 1e-4
PACKAGES = {"jax": (JaxKVPool, JaxPrefixCache, JaxPageError),
            "port": (KVPool, PrefixCache, PageError)}


# --------------------------------------------------------------------------
# the radix tree over the pool, both packages
# --------------------------------------------------------------------------

def _tree(cache) -> list:
    """Every node as (token path, page, last use), sorted."""
    out, stack = [], [(cache.root, ())]
    while stack:
        node, path = stack.pop()
        for chunk, child in node.children.items():
            out.append((path + chunk, int(child.page), child.last_use))
            stack.append((child, path + chunk))
    return sorted(out)


def _checked(cache, errors) -> str:
    try:
        cache.check()
        return "ok"
    except errors:
        return "error"


def _traffic(pkg: str, seed: int) -> list:
    """A seeded sequence of cache and pool operations on one package's
    classes; returns the record of every result and state."""
    pool_cls, cache_cls, errors = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    ps = int(rng.integers(2, 5))
    slots = int(rng.integers(2, 5))
    n_pages = int(rng.integers(6, 20))
    pool = pool_cls(n_pages, ps, slots)
    cache = cache_cls(pool)
    # prompts share few page-aligned prefixes, so they match often
    stems = [rng.integers(0, 4, size=3 * ps).tolist() for _ in range(3)]
    record = []
    for _ in range(60):
        kind = rng.choice(["admit", "admit", "release", "evict", "pressure",
                           "match"])
        slot = int(rng.integers(slots))
        stem = stems[int(rng.integers(len(stems)))]
        prompt = (stem[:int(rng.integers(0, len(stem) + 1))]
                  + rng.integers(0, 4, size=int(rng.integers(1, 2 * ps))
                                 ).tolist())
        try:
            if kind == "match":
                res = cache.match(prompt)
            elif kind == "admit":
                if pool.slot_pages(slot):
                    continue
                tokens = len(prompt) + int(rng.integers(1, 2 * ps))
                matched, mtoks = cache.match(prompt)
                res = [matched, mtoks,
                       pool.can_admit(tokens, shared_pages=matched)]
                if res[-1]:
                    if matched:
                        pool.share(slot, matched)
                        extra = pool.pages_for(tokens) - len(matched)
                        if extra > 0:
                            res.append(pool.extend(slot, extra))
                    else:
                        res.append(pool.reserve(slot, tokens))
                    covered = int(rng.integers(mtoks, len(prompt) + 1))
                    n_full = covered // ps
                    if n_full:
                        res.append(cache.insert(
                            prompt[:n_full * ps],
                            pool.slot_pages(slot)[:n_full]))
            elif kind == "release":
                pages = pool.slot_pages(slot)
                res = pool.release(slot,
                                   cacheable=cache.registered_pages(pages))
            elif kind == "evict":
                res = cache.evict(int(rng.integers(0, 4)))
            else:                    # allocation that evicts on pressure
                if pool.slot_pages(slot):
                    continue
                res = pool.reserve(slot, int(rng.integers(1, n_pages * ps)))
        except errors as err:
            res = ("error", str(err))
        record.append((str(kind), res, pool.snapshot(), _tree(cache),
                       cache.evicted_pages, cache.n_entries,
                       _checked(cache, errors)))
    return record


@pytest.mark.parametrize("seed", range(10))
def test_random_operations_match_jax(seed):
    want, got = _traffic("jax", seed), _traffic("port", seed)
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g == w, (step, g[:2], w[:2])
    assert all(state == "ok" for *_, state in got)


def test_random_operations_reach_sharing_and_eviction():
    """Over the seeds, the traffic shares pages, parks them cached and
    evicts them, through ``evict`` and through the pool's evictor."""
    shared = cached = evicted = 0
    for seed in range(10):
        for kind, res, snap, tree, ev, n, _ in _traffic("port", seed):
            shared += kind == "admit" and isinstance(res, list) \
                and bool(res[0])
            cached += snap["cached"] != []
            evicted = max(evicted, ev)
    assert shared and cached and evicted


def _cases():
    """The unit cases of ``tests/test_prefixcache.py``, each a function
    of one package's classes returning a record."""
    def match_caps_suffix(pool_cls, cache_cls, _):
        pool = pool_cls(16, 4, 4)
        cache = cache_cls(pool)
        toks = list(range(100, 110))
        pages = pool.reserve(0, len(toks) + 4)
        cache.insert(toks[:8], pages[:2])
        return [pages, cache.match(toks + [1, 2, 3]), cache.match(toks[:7]),
                cache.match(toks[:4]), cache.match(toks[:8]),
                cache.match(toks[:4] + [0, 0, 0, 0, 9])]

    def insert_keeps_existing(pool_cls, cache_cls, _):
        pool = pool_cls(16, 4, 4)
        cache = cache_cls(pool)
        t = list(range(8))
        a, b = pool.reserve(0, 8), pool.reserve(1, 8)
        return [cache.insert(t, a[:2]), cache.insert(t, b[:2]),
                cache.match(t + [9]), cache.n_entries]

    def rejects_reregistered(pool_cls, cache_cls, errors):
        pool = pool_cls(16, 4, 4)
        cache = cache_cls(pool)
        pages = pool.reserve(0, 8)
        cache.insert(list(range(8)), pages[:2])
        try:
            cache.insert(list(range(50, 58)), pages[:2])
        except errors as err:
            return str(err)
        return None

    def retire_then_revive(pool_cls, cache_cls, _):
        pool = pool_cls(8, 4, 4)
        cache = cache_cls(pool)
        t = list(range(12))
        pages = pool.reserve(0, 12)
        cache.insert(t[:8], pages[:2])
        pool.release(0, cacheable=cache.registered_pages(pages))
        out = [pool.cached_pages, pool.free_pages]
        got, n = cache.match(t)
        pool.share(1, got)
        cache.check()
        return out + [got, n, pool.cached_pages, pool.snapshot()]

    def lru_leaf_first(pool_cls, cache_cls, _):
        pool = pool_cls(12, 2, 4)
        cache = cache_cls(pool)
        old, new = [9, 9, 8, 8], [7, 7, 6, 6]
        pa = pool.reserve(0, 4)
        cache.insert(old, pa)
        pb = pool.reserve(1, 4)
        cache.insert(new, pb)
        cache.match(old + [1])
        pool.release(0, cacheable=frozenset(pa))
        pool.release(1, cacheable=frozenset(pb))
        out = [cache.evict(1), cache.match(old + [1]), cache.match(new + [1])]
        out += [cache.evict(2), cache.match(old + [1]),
                cache.match(new + [1]), cache.evicted_pages, _tree(cache)]
        cache.check()
        return out

    def evict_skips_mapped(pool_cls, cache_cls, _):
        pool = pool_cls(8, 2, 2)
        cache = cache_cls(pool)
        pages = pool.reserve(0, 4)
        cache.insert([5, 5, 4, 4], pages)
        out = [cache.evict(4), cache.n_entries]
        pool.release(0, cacheable=cache.registered_pages(pages))
        return out + [cache.evict(4), pool.free_pages]

    def pressure_evicts(pool_cls, cache_cls, _):
        pool = pool_cls(4, 2, 2)
        cache = cache_cls(pool)
        pages = pool.reserve(0, 8)
        cache.insert(list(range(8)), pages)
        pool.release(0, cacheable=cache.registered_pages(pages))
        out = [pool.free_pages, pool.cached_pages, pool.reserve(1, 6)]
        cache.check()
        return out + [cache.evicted_pages, cache.n_entries, _tree(cache)]

    return {f.__name__: f for f in (
        match_caps_suffix, insert_keeps_existing, rejects_reregistered,
        retire_then_revive, lru_leaf_first, evict_skips_mapped,
        pressure_evicts)}


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_unit_cases_match_jax(case):
    want = CASES[case](*PACKAGES["jax"])
    got = CASES[case](*PACKAGES["port"])
    assert got == want
    if case == "match_caps_suffix":
        pages = got[0]
        assert got[1:] == [(pages[:2], 8), (pages[:1], 4), ([], 0),
                           (pages[:1], 4), (pages[:1], 4)]
    if case == "pressure_evicts":
        assert got[:2] == [0, 4] and len(got[2]) == 3 and got[3] == 3


@pytest.mark.parametrize("page", [-1, 8, 9], ids=["negative", "sentinel",
                                                  "sink"])
def test_pages_past_the_pool_never_enter_the_tree(page):
    """The pooled caches hold two pages past the pool's 8: the sentinel's
    (read through unallocated entries) and the sink.  Neither is a pool
    page, so the tree refuses them, and the pool never hands them out."""
    pool = KVPool(8, 4, 2)
    cache = PrefixCache(pool)
    with pytest.raises(PageError, match="pool's 8 pages"):
        cache.insert(list(range(8)), [0, page])
    assert cache.n_entries == 0
    got = pool.reserve(0, 32)
    assert sorted(got) == list(range(8)) and pool.sentinel == 8
    cache.check()


# --------------------------------------------------------------------------
# the Batcher with the prefix cache, both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-0.5b").reduced()
    jmodel = JaxModel(jax_get_config("qwen2-0.5b").reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), tparams


def _port(setup, requests, max_new, eos=None, **kw):
    _, _, _, model, tparams = setup
    b = Batcher(model, tparams, ServeConfig(dtype=torch.float32, **kw),
                eos_id=eos)
    for rid, p in requests:
        b.submit(rid, p)
    b.run(max_new=max_new)
    return b


def _jax(setup, requests, max_new, eos=None, **kw):
    _, jmodel, jparams, _, _ = setup
    b = JaxBatcher(jmodel, jparams, JaxServeConfig(dtype=jnp.float32, **kw),
                   eos_id=eos)
    for rid, p in requests:
        b.submit(rid, p)
    b.run(max_new=max_new)
    return b


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


def _assert_matches_jax(setup, requests, jb, tb):
    """The port's batcher gave JAX's results and schedule; where a stream
    differs at a near-tie, only the streams are compared."""
    prompts = dict(requests)
    equal = all([_same_or_near_tie(setup, prompts[rid], tb.results[rid],
                                   jb.results[rid]) for rid in prompts])
    assert set(tb.results) == set(jb.results) == set(prompts)
    if not equal:
        return
    assert tb.admit_order == jb.admit_order
    assert tb.prefix_stats() == jb.prefix_stats()
    assert tb.spec_stats() == jb.spec_stats()
    tj, jj = tb.join_stats(), jb.join_stats()
    for key in ("joins", "chunk_joins", "budget_deferrals"):
        assert tj[key] == jj[key], key
    assert tb.kv_samples == jb.kv_samples
    assert tb.kv_utilization() == jb.kv_utilization()


def _assert_drained(b):
    assert b.pool.used_pages == 0
    assert b.pool.free_pages + b.pool.cached_pages == b.pool.n_pages
    assert int(b.pool.refcount.sum()) == 0
    b.prefix.check()


def _system_requests(cfg, seed, system, sizes):
    rng = np.random.default_rng(seed)
    sys_toks = rng.integers(0, cfg.vocab, size=system).tolist()
    return [(i, sys_toks + rng.integers(0, cfg.vocab, size=n).tolist())
            for i, n in enumerate(sizes)]


BASE = dict(max_len=64, sync_every=4, paged=True, page_size=8)


def _cfg(**kw):
    return {**BASE, **kw}


def test_prefix_matches_jax_and_skips_prefill(setup):
    """Mixed suffix lengths behind a 17-token system prompt (two full
    pages of 8), one prompt page-aligned: JAX's results and stats, and
    the cache-off streams."""
    cfg = setup[0]
    requests = _system_requests(cfg, 11, 17, [1, 4, 7, 2])
    kw = _cfg(batch=4)
    jb = _jax(setup, requests, 12, prefix_cache=True, **kw)
    tb = _port(setup, requests, 12, prefix_cache=True, **kw)
    _assert_matches_jax(setup, requests, jb, tb)
    off = _port(setup, requests, 12, **kw)
    for rid, p in requests:
        _same_or_near_tie(setup, p, tb.results[rid], off.results[rid])
    s = tb.prefix_stats()
    assert s["hits"] == 3 and s["prefill_skipped"] == 3 * 16
    assert s["hit_rate"] > 0.5
    assert off.prefix_stats()["hit_rate"] == 0.0
    _assert_drained(tb)


def test_prefix_refills_rehit_the_cache(setup):
    """Seven requests through two slots: every admission after the first
    hits pages parked cached by retired holders."""
    cfg = setup[0]
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab, size=16).tolist()
    requests = [(i, system + rng.integers(
        0, cfg.vocab, size=int(rng.integers(1, 6))).tolist())
        for i in range(7)]
    kw = _cfg(batch=2)
    jb = _jax(setup, requests, 8, prefix_cache=True, **kw)
    tb = _port(setup, requests, 8, prefix_cache=True, **kw)
    _assert_matches_jax(setup, requests, jb, tb)
    assert tb.prefix_stats()["hits"] == 6
    assert tb.prefix_stats()["evicted_pages"] == 0
    _assert_drained(tb)


def test_prefix_eos_mid_batch(setup):
    cfg = setup[0]
    requests = _system_requests(cfg, 11, 17, [1, 4, 7, 2])
    kw = _cfg(batch=4)
    free = _port(setup, requests, 12, **kw).results
    eos = free[0][4]
    tb = _port(setup, requests, 12, eos=eos, prefix_cache=True, **kw)
    jb = _jax(setup, requests, 12, eos=eos, prefix_cache=True, **kw)
    _assert_matches_jax(setup, requests, jb, tb)
    assert any(len(v) < 12 for v in tb.results.values())
    off = _port(setup, requests, 12, eos=eos, **kw)
    for rid, p in requests:
        _same_or_near_tie(setup, p, tb.results[rid], off.results[rid])
    _assert_drained(tb)


def test_prefix_eviction_in_a_tight_pool(setup):
    """Two system prompts in turn through a 4-page pool: admission
    reclaims cached pages (LRU, leaf-first) through the pool's
    evictor."""
    cfg = setup[0]
    rng = np.random.default_rng(9)
    sys_a = rng.integers(0, cfg.vocab, size=16).tolist()
    sys_b = rng.integers(0, cfg.vocab, size=16).tolist()
    requests = [(i, (sys_a if i % 2 == 0 else sys_b) + rng.integers(
        0, cfg.vocab, size=int(rng.integers(1, 5))).tolist())
        for i in range(6)]
    kw = _cfg(batch=1, total_pages=4)
    jb = _jax(setup, requests, 6, prefix_cache=True, **kw)
    tb = _port(setup, requests, 6, prefix_cache=True, **kw)
    _assert_matches_jax(setup, requests, jb, tb)
    assert tb.prefix_stats()["evicted_pages"] > 0
    off = _port(setup, requests, 6, **kw)
    for rid, p in requests:
        _same_or_near_tie(setup, p, tb.results[rid], off.results[rid])
    _assert_drained(tb)


def test_prefix_same_round_hit(setup):
    """Three prompts of one system prefix admitted in one round: the
    second and third match pages the first writes in that same join."""
    cfg = setup[0]
    rng = np.random.default_rng(4)
    system = rng.integers(0, cfg.vocab, size=16).tolist()
    requests = [(i, system + rng.integers(
        0, cfg.vocab, size=int(rng.integers(1, 5))).tolist())
        for i in range(3)]
    kw = _cfg(batch=3)
    jb = _jax(setup, requests, 8, prefix_cache=True, **kw)
    tb = _port(setup, requests, 8, prefix_cache=True, **kw)
    _assert_matches_jax(setup, requests, jb, tb)
    assert tb.prefix_stats()["hits"] == 2 and tb.joins == 1
    off = _port(setup, requests, 8, **kw)
    for rid, p in requests:
        _same_or_near_tie(setup, p, tb.results[rid], off.results[rid])
    _assert_drained(tb)


def test_prefix_cache_requires_paged_as_in_jax(setup):
    _, jmodel, jparams, model, tparams = setup
    errors = []
    for make in (lambda: JaxBatcher(jmodel, jparams, JaxServeConfig(
                     max_len=64, batch=2, prefix_cache=True)),
                 lambda: Batcher(model, tparams, ServeConfig(
                     max_len=64, batch=2, prefix_cache=True))):
        with pytest.raises(ValueError, match="paged") as err:
            make()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
