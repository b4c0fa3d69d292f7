"""Chunked prefill and the round-token budget in the port, against the
JAX ``Batcher`` on the same float32 weights at qwen2-0.5b ``reduced()``
(the cases of ``tests/test_serve_chunked.py`` and the budget's of
``tests/test_serve_spec.py``): a long prompt chunked among short ones,
chunk edges on page edges, prompts shorter than one chunk, a prefix hit
that leaves a suffix shorter than a chunk, EOS retiring a slot while
another is PREFILLING, and a round budget that defers pieces and still
progresses.  Each case gives JAX's results, admission order,
``prefix_stats()``, ``join_stats()`` chunk counters and
``kv_utilization()``, or a stream that differs at a shown logit near-tie
(1e-4); and in the port, chunked gives unchunked's greedy streams.  The
configuration checks match JAX's, message for message."""
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
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import forward, logits_fn
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Batcher

torch.set_num_threads(1)

NEAR_TIE = 1e-4
BASE = dict(max_len=96, batch=3, sync_every=4, paged=True, page_size=8,
            total_pages=36)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-0.5b").reduced()
    jmodel = JaxModel(jax_get_config("qwen2-0.5b").reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), tparams


def _port(setup, requests, max_new=10, eos=None, hook=None, **kw):
    _, _, _, model, tparams = setup
    b = Batcher(model, tparams,
                ServeConfig(dtype=torch.float32, **{**BASE, **kw}),
                eos_id=eos)
    if hook is not None:
        hook(b)
    for rid, p in requests:
        b.submit(rid, p)
    b.run(max_new=max_new)
    return b


def _jax(setup, requests, max_new=10, eos=None, **kw):
    _, jmodel, jparams, _, _ = setup
    b = JaxBatcher(jmodel, jparams,
                   JaxServeConfig(dtype=jnp.float32, **{**BASE, **kw}),
                   eos_id=eos)
    for rid, p in requests:
        b.submit(rid, p)
    b.run(max_new=max_new)
    return b


def _requests(cfg, sizes, seed=1, system=0):
    rng = np.random.default_rng(seed)
    sys_toks = rng.integers(0, cfg.vocab, size=system).tolist()
    return [(i, sys_toks + rng.integers(0, cfg.vocab, size=n).tolist())
            for i, n in enumerate(sizes)]


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
    """JAX's results and schedule; where a stream differs at a near-tie,
    only the streams are compared."""
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
    assert (tb.chunk_joins, tb.budget_deferrals) == (jb.chunk_joins,
                                                     jb.budget_deferrals)
    assert tb.kv_samples == jb.kv_samples
    assert tb.kv_utilization() == jb.kv_utilization()


def _assert_same_streams(setup, requests, a, b):
    for rid, p in requests:
        _same_or_near_tie(setup, p, a.results[rid], b.results[rid])


def _assert_drained(b):
    assert b.pool.used_pages == 0
    assert int(b.pool.refcount.sum()) == 0
    b.pool.check()


def test_chunked_long_and_short_mixed(setup):
    """A 40-token prompt 16 tokens at a time among short ones: JAX's
    schedule, unchunked's tokens, more and smaller joins."""
    requests = _requests(setup[0], [40, 5, 23, 4])
    tb = _port(setup, requests, prefill_chunk=16)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, prefill_chunk=16), tb)
    off = _port(setup, requests)
    _assert_same_streams(setup, requests, tb, off)
    assert tb.chunk_joins > 0 and off.chunk_joins == 0
    assert tb.join_stats()["joins"] > off.join_stats()["joins"]
    _assert_drained(tb)


def test_chunk_boundary_on_page_boundary(setup):
    """Prompts of exactly 2 and 3 chunks (and 4 and 6 pages): the last
    chunk is full and commits with nothing left."""
    requests = _requests(setup[0], [32, 48, 16], seed=3)
    tb = _port(setup, requests, prefill_chunk=16)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, prefill_chunk=16), tb)
    _assert_same_streams(setup, requests, tb, _port(setup, requests))
    assert tb.chunk_joins > 0
    _assert_drained(tb)


def test_prompt_shorter_than_one_chunk(setup):
    """Every prompt below the chunk commits on its first join: no
    continuation, the unchunked join count."""
    requests = _requests(setup[0], [7, 3, 11, 5], seed=5)
    tb = _port(setup, requests, prefill_chunk=16)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, prefill_chunk=16), tb)
    off = _port(setup, requests)
    _assert_same_streams(setup, requests, tb, off)
    assert tb.chunk_joins == 0
    assert tb.join_stats()["joins"] == off.join_stats()["joins"]


def test_prefix_hit_leaves_a_subchunk_suffix(setup):
    """24 shared tokens (3 pages) and suffixes of 2-9 tokens: a hit
    leaves less than a chunk, which commits at once at its depth."""
    requests = _requests(setup[0], [2, 9, 5, 3], seed=7, system=24)
    kw = dict(prefill_chunk=16, prefix_cache=True)
    tb = _port(setup, requests, **kw)
    _assert_matches_jax(setup, requests, _jax(setup, requests, **kw), tb)
    _assert_same_streams(setup, requests, tb, _port(setup, requests))
    s = tb.prefix_stats()
    assert s["hits"] >= 3 and s["prefill_skipped"] > 0
    tb.prefix.check()
    assert tb.pool.used_pages == 0


def test_eos_while_another_slot_is_prefilling(setup):
    """A short request's EOS retires it while the 56-token prompt is
    still PREFILLING in chunks of 8: the frozen slot is untouched."""
    requests = _requests(setup[0], [56, 4, 5], seed=9)
    eos = _port(setup, requests, max_new=12).results[1][2]
    during: list[bool] = []

    def hook(b):
        retire = b._retire

        def watched(slot, rid, out, now):
            during.append(any(b.slot_pending))
            retire(slot, rid, out, now)
        b._retire = watched
    tb = _port(setup, requests, max_new=12, eos=eos, hook=hook,
               prefill_chunk=8)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, max_new=12, eos=eos,
                             prefill_chunk=8), tb)
    off = _port(setup, requests, max_new=12, eos=eos)
    _assert_same_streams(setup, requests, tb, off)
    assert any(len(v) < 12 and v[-1] == eos for v in tb.results.values())
    assert any(during), "no retirement while a slot was PREFILLING"
    assert tb.chunk_joins > 0
    _assert_drained(tb)


def test_round_budget_defers_and_keeps_the_tokens(setup):
    """A budget of 8 tokens a round defers continuations (two prompts
    PREFILLING at once cannot both take a chunk)."""
    requests = _requests(setup[0], [40, 33, 5], seed=15)
    kw = dict(prefill_chunk=8, prefill_round_tokens=8)
    tb = _port(setup, requests, **kw)
    _assert_matches_jax(setup, requests, _jax(setup, requests, **kw), tb)
    uncapped = _port(setup, requests, prefill_chunk=8)
    _assert_same_streams(setup, requests, tb, uncapped)
    assert tb.join_stats()["budget_deferrals"] > 0
    assert uncapped.join_stats()["budget_deferrals"] == 0
    _assert_drained(tb)


def test_round_budget_below_one_chunk_still_progresses(setup):
    """A budget of 1 token still takes one piece a round."""
    requests = _requests(setup[0], [24, 17], seed=17)
    kw = dict(prefill_chunk=16, prefill_round_tokens=1)
    tb = _port(setup, requests, **kw)
    _assert_matches_jax(setup, requests, _jax(setup, requests, **kw), tb)
    _assert_same_streams(setup, requests, tb,
                         _port(setup, requests, prefill_chunk=16))
    _assert_drained(tb)


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=16),
    dict(paged=True, page_size=8, prefill_chunk=0),
    dict(paged=True, page_size=8, prefill_chunk=-8),
    dict(paged=True, page_size=8, prefill_chunk=12),
    dict(paged=True, page_size=8, prefill_round_tokens=0),
], ids=["unpaged", "zero", "negative", "off-page", "zero-budget"])
def test_chunk_validation_matches_jax(setup, kw):
    _, jmodel, jparams, model, tparams = setup
    messages = []
    for make in (lambda: JaxBatcher(jmodel, jparams, JaxServeConfig(
                     max_len=32, batch=2, **kw)),
                 lambda: Batcher(model, tparams, ServeConfig(
                     max_len=32, batch=2, **kw))):
        with pytest.raises(ValueError,
                           match="paged|prefill_chunk|prefill_round_tokens"
                           ) as err:
            make()
        messages.append(str(err.value))
    assert messages[1] == messages[0]
