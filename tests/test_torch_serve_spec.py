"""Self-speculative decoding in the port, against the JAX package.

``ngram_propose`` equals JAX's bit for bit on seeded histories (k 1-6, n
1-3, every length 0 to S-1, per-slot independence) and on the drafter
cases of ``tests/test_serve_spec.py``.  The port's ``Batcher`` with
``speculate_k`` against JAX's on the same float32 weights at qwen2-0.5b
``reduced()`` (that file's cases: mixed lengths, repetitive prompts that
accept drafts, EOS inside an accepted window, refills, and speculation
with the prefix cache, with chunked prefill, and with all three and a
round budget): JAX's results, admission order, ``spec_stats()``,
``prefix_stats()``, chunk counters and ``kv_utilization()``, or a stream
that differs at a shown logit near-tie (1e-4); and in the port,
speculation on gives the plain greedy loop's streams.  The speculative
loop writes its token history and the slot state in place (the same
tensors across segments, which a decode graph needs) and emits [steps,
B, k+1].  The configuration checks, and the speculation window's place
in ``max_len``, match JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ngram_propose as jax_ngram_propose
from repro.serve.scheduler import Batcher as JaxBatcher
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import forward, logits_fn
from repro_torch.serve.engine import PAD_TOKEN, ServeConfig, ngram_propose
from repro_torch.serve.scheduler import Batcher

torch.set_num_threads(1)

NEAR_TIE = 1e-4
BASE = dict(max_len=96, batch=3, sync_every=4, paged=True, page_size=8,
            total_pages=36)


# --------------------------------------------------------------------------
# the drafter
# --------------------------------------------------------------------------

def _both(history, lengths, k, n):
    want = np.asarray(jax_ngram_propose(jnp.asarray(history, jnp.int32),
                                        jnp.asarray(lengths, jnp.int32),
                                        k=k, n=n))
    got = ngram_propose(torch.as_tensor(np.asarray(history, np.int32)),
                        torch.as_tensor(np.asarray(lengths, np.int32)),
                        k=k, n=n)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_ngram_propose_matches_jax(k, n):
    """Histories over 3 token ids (so windows repeat), one row a length
    from 0 to S-1, and a row of one repeated token."""
    rng = np.random.default_rng(10 * k + n)
    s = 14
    history = rng.integers(0, 3, size=(s + 1, s))
    history[s] = 7
    lengths = list(range(s)) + [s - 1]
    got, want = _both(history, lengths, k, n)
    np.testing.assert_array_equal(got, want)
    assert (got[s] == 7).all()


@pytest.mark.parametrize("history,lengths,k,n,drafts", [
    ([[1, 2, 3, 1, 2, 3, 1, 2, 0, 0, 0, 0]], [7], 5, 2, [[3, 1, 2, 3, 1]]),
    ([[9, 4, 4, 4, 0, 0]], [3], 3, 2, [[4, 4, 4]]),
    ([[5, 6, 7, 0, 0, 0]], [2], 3, 2, [[7, 7, 7]]),
    ([[8, 8, 8, 8, 0, 0], [1, 2, 3, 4, 0, 0]], [3, 3], 2, 2,
     [[8, 8], [4, 4]]),
], ids=["period", "run", "no-match", "per-slot"])
def test_ngram_propose_drafter_cases(history, lengths, k, n, drafts):
    got, want = _both(history, lengths, k, n)
    assert got.tolist() == want.tolist() == drafts


def test_ngram_propose_rows_are_independent():
    """Each row drafted alone gives its row of the batch's drafts."""
    rng = np.random.default_rng(3)
    history = rng.integers(0, 4, size=(6, 20))
    lengths = rng.integers(0, 20, size=6)
    batch = ngram_propose(torch.as_tensor(history, dtype=torch.int32),
                          torch.as_tensor(lengths, dtype=torch.int32),
                          k=4, n=2)
    for i in range(6):
        alone = ngram_propose(
            torch.as_tensor(history[i:i + 1], dtype=torch.int32),
            torch.as_tensor(lengths[i:i + 1], dtype=torch.int32), k=4, n=2)
        assert torch.equal(alone[0], batch[i])


# --------------------------------------------------------------------------
# the Batcher with speculation, both packages
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


def _mixed(cfg, sizes, seed=1, system=0):
    rng = np.random.default_rng(seed)
    sys_toks = rng.integers(0, cfg.vocab, size=system).tolist()
    return [(i, sys_toks + rng.integers(0, cfg.vocab, size=n).tolist())
            for i, n in enumerate(sizes)]


def _repetitive(cfg, n, plen=10, seed=2):
    tok = int(np.random.default_rng(seed).integers(0, cfg.vocab))
    return [(i, [tok] * plen) for i in range(n)]


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
    assert tb.spec_stats() == jb.spec_stats()
    assert tb.prefix_stats() == jb.prefix_stats()
    tj, jj = tb.join_stats(), jb.join_stats()
    for key in ("joins", "chunk_joins", "budget_deferrals"):
        assert tj[key] == jj[key], key
    assert tb.kv_samples == jb.kv_samples
    assert tb.kv_utilization() == jb.kv_utilization()


def _assert_plain_streams(setup, requests, tb, max_new=10, eos=None, **kw):
    """Speculation on gives the port's plain greedy streams."""
    off = _port(setup, requests, max_new=max_new, eos=eos, **kw)
    assert off.spec_stats()["steps"] == 0
    for rid, p in requests:
        _same_or_near_tie(setup, p, tb.results[rid], off.results[rid])


def _assert_drained(b):
    assert b.pool.used_pages == 0
    assert int(b.pool.refcount.sum()) == 0
    b.pool.check()


def test_spec_mixed_lengths(setup):
    requests = _mixed(setup[0], [9, 3, 14])
    tb = _port(setup, requests, speculate_k=3)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, speculate_k=3), tb)
    _assert_plain_streams(setup, requests, tb)
    assert tb.spec_stats()["steps"] > 0
    _assert_drained(tb)


def test_spec_repetitive_prompts_accept_drafts(setup):
    requests = _repetitive(setup[0], 3)
    tb = _port(setup, requests, max_new=16, speculate_k=3)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, max_new=16, speculate_k=3), tb)
    _assert_plain_streams(setup, requests, tb, max_new=16)
    s = tb.spec_stats()
    assert s["accepted"] > 0 and s["tokens_per_step"] > 1.0
    assert s["enabled"] and s["k"] == 3 and s["proposed"] == 3 * s["steps"]
    _assert_drained(tb)


def test_spec_eos_inside_the_window(setup):
    """EOS committed from inside an accepted window: the advance stops at
    it, it is kept, and the slot retires while its mates go on."""
    requests = _repetitive(setup[0], 3, seed=5)
    eos = _port(setup, requests, max_new=16).results[0][3]
    tb = _port(setup, requests, max_new=16, eos=eos, speculate_k=4)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, max_new=16, eos=eos,
                             speculate_k=4), tb)
    _assert_plain_streams(setup, requests, tb, max_new=16, eos=eos)
    assert any(len(v) < 16 for v in tb.results.values())
    for out in tb.results.values():
        if len(out) < 16:
            assert out[-1] == eos and eos not in out[:-1]
    _assert_drained(tb)


def test_spec_with_refills(setup):
    """Six requests through three slots: a refilled slot's history row
    is rewritten from the new prompt."""
    requests = _mixed(setup[0], [7, 3, 11, 5, 9, 4], seed=7)
    tb = _port(setup, requests, max_new=8, speculate_k=3)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, max_new=8, speculate_k=3), tb)
    _assert_plain_streams(setup, requests, tb, max_new=8)
    assert tb.joins > 1
    _assert_drained(tb)


def test_spec_with_prefix_cache(setup):
    requests = _mixed(setup[0], [2, 5, 3, 4], seed=9, system=16)
    kw = dict(speculate_k=3, prefix_cache=True)
    tb = _port(setup, requests, max_new=8, **kw)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, max_new=8, **kw), tb)
    _assert_plain_streams(setup, requests, tb, max_new=8)
    s = tb.prefix_stats()
    assert s["hits"] >= 3 and s["prefill_skipped"] > 0
    tb.prefix.check()
    assert tb.pool.used_pages == 0


def test_spec_with_chunked_prefill(setup):
    """A long prompt chunks while the others decode speculatively: the
    frozen slot's verify writes land in its private pages and its next
    chunk overwrites them."""
    requests = _mixed(setup[0], [40, 5, 23], seed=11)
    kw = dict(speculate_k=3, prefill_chunk=16)
    tb = _port(setup, requests, **kw)
    _assert_matches_jax(setup, requests, _jax(setup, requests, **kw), tb)
    _assert_plain_streams(setup, requests, tb)
    assert tb.chunk_joins > 0
    _assert_drained(tb)


def test_spec_chunked_prefix_budget_and_eos_together(setup):
    """All three features and a round budget over system-prefixed
    traffic with an EOS: JAX's schedule and the plain streams."""
    requests = _mixed(setup[0], [21, 3, 9, 30, 2], seed=13, system=16)
    eos = _port(setup, requests, max_new=9).results[2][4]
    kw = dict(speculate_k=4, prefill_chunk=8, prefix_cache=True,
              prefill_round_tokens=24)
    tb = _port(setup, requests, max_new=9, eos=eos, **kw)
    _assert_matches_jax(setup, requests,
                        _jax(setup, requests, max_new=9, eos=eos, **kw), tb)
    _assert_plain_streams(setup, requests, tb, max_new=9, eos=eos)
    assert tb.chunk_joins > 0 and tb.prefix_stats()["hits"] > 0
    assert tb.spec_stats()["steps"] > 0
    tb.prefix.check()
    assert tb.pool.used_pages == 0


def test_spec_loop_writes_history_and_state_in_place(setup):
    """Across every segment the speculative loop reads and writes the
    same history, slot-state and cache tensors, keyed as JAX keys its
    loops, and emits [steps, B, k+1] bursts ended by PAD."""
    requests = _mixed(setup[0], [12, 30, 5, 9, 17], seed=21)
    addresses: list[tuple] = []
    shapes: list[tuple] = []

    def hook(b):
        segment = b._decode_segment

        def watched(steps):
            out = segment(steps)
            shapes.append(tuple(out.shape))
            tensors = [b.history, b.tok, b.lengths, b.done, b.remaining]
            tensors += [c[n] for c in b.caches for n in ("k", "v")]
            addresses.append(tuple(t.data_ptr() for t in tensors))
            burst = (out != PAD_TOKEN).to(torch.int32)
            # a burst is a prefix: no token after a PAD within a step
            assert (burst[..., 1:] <= burst[..., :-1]).all()
            return out
        b._decode_segment = watched
    tb = _port(setup, requests, max_new=12, hook=hook, speculate_k=3,
               prefill_chunk=8, sync_every=3)
    assert tb.segments > 2 and len(set(addresses)) == 1
    assert set(shapes) == {(3, BASE["batch"], 4)}
    assert tb.history.shape == (BASE["batch"], BASE["max_len"] + 1)
    assert all(spec for _, _, spec in tb._loops)
    assert not tb.graphs and tb.graph_count == 0
    _assert_plain_streams(setup, requests, tb, max_new=12, sync_every=3)


def test_reset_stats_isolates_a_warm_wave(setup):
    requests = _repetitive(setup[0], 3, seed=19)
    b = _port(setup, requests, max_new=8, speculate_k=3)
    first = b.spec_stats()
    assert first["steps"] > 0
    b.reset_stats()
    assert b.spec_stats()["steps"] == 0
    assert b.latency_stats()["requests"] == 0
    for rid, p in requests:
        b.submit(rid + 100, p)
    b.run(max_new=8)
    assert b.spec_stats() == first
    assert {r - 100: v for r, v in b.results.items() if r >= 100} \
        == {r: v for r, v in b.results.items() if r < 100}


@pytest.mark.parametrize("kw", [
    dict(speculate_k=3),
    dict(paged=True, speculate_k=0),
    dict(paged=True, speculate_k=3, temperature=0.7),
    dict(paged=True, speculate_k=3, speculate_ngram=0),
], ids=["unpaged", "zero", "sampled", "zero-ngram"])
def test_spec_validation_matches_jax(setup, kw):
    _, jmodel, jparams, model, tparams = setup
    messages = []
    for make in (lambda: JaxBatcher(jmodel, jparams, JaxServeConfig(
                     max_len=32, batch=2, page_size=8, **kw)),
                 lambda: Batcher(model, tparams, ServeConfig(
                     max_len=32, batch=2, page_size=8, **kw))):
        with pytest.raises(ValueError,
                           match="paged|speculate_k|greedy|speculate_ngram"
                           ) as err:
            make()
        messages.append(str(err.value))
    assert messages[1] == messages[0]


def test_spec_window_counts_toward_max_len(setup):
    """prompt + max_new + k must fit max_len (a verify writes up to
    lengths + k), as in JAX, with JAX's message."""
    _, jmodel, jparams, model, tparams = setup
    messages = []
    for b in (JaxBatcher(jmodel, jparams, JaxServeConfig(
                  dtype=jnp.float32, **BASE, speculate_k=4)),
              Batcher(model, tparams, ServeConfig(
                  dtype=torch.float32, **BASE, speculate_k=4))):
        b.submit(0, list(range(1, 84)))          # 83 + 10 + 4 > 96
        with pytest.raises(ValueError, match="speculation window") as err:
            b.run(max_new=10)
        messages.append(str(err.value))
    assert messages[1] == messages[0]
