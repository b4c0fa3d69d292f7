"""Serving the SSM models through the port's dense and paged ``Batcher``:
mamba2-370m and the zamba2-1.2b hybrid at ``reduced()`` in float32, on the
JAX ``init`` weights bridged through numpy.

The port's join starts each joining row's SSM state and conv window at
zero and stops its recurrence at the row's own prompt length, so a
request's tokens do not depend on the join's padding or on a slot's
previous occupant: the semantics JAX's own oracle states ("per-slot
lengths make each row's output independent of the other rows",
``repro.serve.reference``).  JAX's batchers do not keep it for SSM
models: the padding of a mixed-length join enters the recurrent state,
and a reused paged slot starts from its previous occupant's state.  So:

- at mixed prompt lengths, with refills by EOS, both port batchers equal
  JAX's ``reference_decode`` run on each request alone (no padding);
- with every prompt exactly the join's width (16 or 32 tokens), they
  equal JAX's own dense and paged batchers, across refills;
- a join leaves every other slot's conv window and state bit for bit;
- the four attention-only features are refused in JAX's words, before
  the batcher reads ``params``;
- one test records the reference fault: JAX's batcher at mixed lengths
  differs from its own per-request reference, where the port's does not.

JAX's reference runs jitted (prefill and decode step), request by
request."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.reference import reference_decode as jax_reference
from repro.serve.scheduler import Batcher as JaxBatcher
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.serve.engine import ServeConfig, make_join, make_paged_join
from repro_torch.serve.scheduler import Batcher

torch.set_num_threads(1)

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
MAX_NEW = 8
BASE = dict(max_len=64, batch=2, sync_every=4)
LAYOUTS = {"dense": {}, "paged": dict(paged=True, page_size=8)}
MIXED = [3, 8, 5, 11, 7]           # prompt lengths: every join is padded


class _Jitted:
    """A JAX model whose ``prefill`` and ``decode_step`` are jitted, for
    ``reference_decode`` (which calls them eagerly)."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.prefill = jax.jit(model.prefill, static_argnums=2,
                               static_argnames="dtype")
        self.decode_step = jax.jit(model.decode_step,
                                   static_argnames="dtype")


def _truncated(stream, eos):
    """A stream cut after its first ``eos`` (kept), as decoding with that
    EOS would end it."""
    return stream[:stream.index(eos) + 1] if eos in stream else stream


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """Both packages' models and weights, the mixed-length requests, JAX's
    per-request reference streams for them, and an EOS id that retires a
    request mid-stream (so slots are refilled)."""
    arch = request.param
    cfg = get_config(arch).reduced()
    jmodel = JaxModel(jax_get_config(arch).reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jax.jit(jmodel.init)(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(2)
    requests = [(i, rng.integers(0, cfg.vocab, size=n).tolist())
                for i, n in enumerate(MIXED)]
    jcfg = JaxServeConfig(dtype=jnp.float32, **BASE)
    solo = {rid: jax_reference(_Jitted(jmodel), jparams, jcfg,
                               [(rid, p)], MAX_NEW)[rid]
            for rid, p in requests}
    return dict(cfg=cfg, jmodel=jmodel, jparams=jparams, model=Model(cfg),
                params=params_from_numpy(tree, device="cpu"),
                requests=requests, solo=solo, eos=solo[0][2])


def _serve(batcher, requests, max_new=MAX_NEW):
    for rid, p in requests:
        batcher.submit(rid, p)
    batcher.run(max_new=max_new)
    return batcher.results


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_streams_equal_jax_reference_per_request(served, layout):
    """Five requests of 3-11 tokens on two slots, EOS refills: each
    request's greedy stream is JAX's reference on that request alone."""
    s = served
    eos = s["eos"]
    got = _serve(Batcher(s["model"], s["params"],
                         ServeConfig(dtype=torch.float32, **BASE,
                                     **LAYOUTS[layout]), eos_id=eos),
                 s["requests"])
    want = {rid: _truncated(v, eos) for rid, v in s["solo"].items()}
    assert any(len(v) < MAX_NEW for v in want.values())     # a refill
    assert got == want


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("width", [16, 32])
def test_unpadded_streams_equal_jax_batchers(served, layout, width):
    """Every prompt exactly the join's width: no row is padded, so the
    port's join is JAX's arithmetic, and the streams of both packages'
    batchers are equal across EOS refills (the counterpart of
    ``test_serve_paged.py::test_paged_ssm_hybrid_across_refills``)."""
    s = served
    rng = np.random.default_rng(width)
    requests = [(i, rng.integers(0, s["cfg"].vocab, size=width).tolist())
                for i in range(5)]
    free = _serve(Batcher(s["model"], s["params"],
                          ServeConfig(dtype=torch.float32, **BASE)),
                  requests)
    eos = free[0][2]
    jax_got = _serve(JaxBatcher(s["jmodel"], s["jparams"],
                                JaxServeConfig(dtype=jnp.float32, **BASE,
                                               **LAYOUTS[layout]),
                                eos_id=eos), requests)
    got = _serve(Batcher(s["model"], s["params"],
                         ServeConfig(dtype=torch.float32, **BASE,
                                     **LAYOUTS[layout]), eos_id=eos),
                 requests)
    assert any(len(v) < MAX_NEW for v in got.values())      # a refill
    assert got == jax_got


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_join_keeps_other_slots_ssm_state_bitwise(served, layout):
    """A join into slot 1 of 3, with every slot's SSM window and state
    holding other values: slots 0 and 2 keep theirs bit for bit, and slot
    1 takes the fresh state of its prompt's prefill alone."""
    s = served
    cfg, model, params = s["cfg"], s["model"], s["params"]
    scfg = ServeConfig(dtype=torch.float32, max_len=32, batch=3,
                       **LAYOUTS[layout])
    if layout == "paged":
        caches = model.init_paged_caches(3, scfg.pool_pages, scfg.page_size,
                                         torch.float32, device="cpu")
    else:
        caches = model.init_caches(3, scfg.max_len, torch.float32,
                                   device="cpu")
    gen = torch.Generator().manual_seed(0)
    ssm = [c for seg, c in zip(cfg.resolved_segments(), caches)
           if seg.kind.value == "ssm"]
    for c in ssm:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    before = [{k: t.clone() for k, t in c.items()} for c in ssm]
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, size=(1, 5)).astype(np.int32))
    state = (torch.zeros((3, 1), dtype=torch.int32),
             torch.zeros(3, dtype=torch.int32),
             torch.ones(3, dtype=torch.bool),
             torch.zeros(3, dtype=torch.int32))
    if layout == "paged":
        join = make_paged_join(model, scfg, eos_id=None)
        prompts = torch.zeros((3, 16), dtype=torch.int32)
        prompts[1, :5] = prompt[0]
        mask = torch.tensor([False, True, False])
        table = torch.arange(scfg.pool_pages, dtype=torch.int32).reshape(3,
                                                                         -1)
        join(params, caches, *state, mask, prompts,
             torch.tensor([1, 5, 1], dtype=torch.int32),
             torch.full((3,), 4, dtype=torch.int32), None, table,
             torch.zeros(3, dtype=torch.int32), mask)
    else:
        join = make_join(model, scfg, eos_id=None)
        prompts = torch.zeros((1, 16), dtype=torch.int32)
        prompts[0, :5] = prompt[0]
        join(params, caches, *state, torch.tensor([1]), prompts,
             torch.tensor([5], dtype=torch.int32),
             torch.tensor([4], dtype=torch.int32), None)
    _, alone = model.prefill(params, {"tokens": prompt}, 8,
                             dtype=torch.float32)
    alone = [c for seg, c in zip(cfg.resolved_segments(), alone)
             if seg.kind.value == "ssm"]
    for c, old, fresh in zip(ssm, before, alone):
        for name, t in c.items():
            assert torch.equal(t[:, [0, 2]], old[name][:, [0, 2]])
            np.testing.assert_allclose(t[:, 1].numpy(),
                                       fresh[name][:, 0].numpy(),
                                       rtol=1e-5, atol=1e-5)


REFUSED = {
    "optimistic": dict(paged=True, admission_mode="optimistic"),
    "prefill_chunk": dict(paged=True, page_size=8, prefill_chunk=8),
    "speculate_k": dict(paged=True, speculate_k=3),
    "prefix_cache": dict(paged=True, page_size=8, prefix_cache=True),
}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("feature", list(REFUSED))
def test_attention_only_features_refused_in_jax_words(arch, feature):
    """The same ``ValueError`` as JAX's, raised before ``params`` is read
    (the port's batcher is given none) and before any cache exists."""
    kw = dict(max_len=32, batch=2, **REFUSED[feature])
    with pytest.raises(ValueError, match="attention-only") as jerr:
        JaxBatcher(JaxModel(jax_get_config(arch).reduced()), None,
                   JaxServeConfig(**kw))
    with pytest.raises(ValueError, match="attention-only") as terr:
        Batcher(Model(get_config(arch).reduced()), None, ServeConfig(**kw))
    assert str(terr.value) == str(jerr.value)


def test_reference_fault_jax_batcher_leaks_join_padding(served):
    """Recorded so that a later reader sees why the port is not held to
    JAX's batcher at mixed lengths: there JAX's streams differ from its
    own per-request reference (the pad tokens run through the recurrence
    and the conv window), and the port's equal it."""
    s = served
    jcfg = JaxServeConfig(dtype=jnp.float32, **BASE)
    jax_got = _serve(JaxBatcher(s["jmodel"], s["jparams"], jcfg),
                     s["requests"])
    got = _serve(Batcher(s["model"], s["params"],
                         ServeConfig(dtype=torch.float32, **BASE)),
                 s["requests"])
    assert got == s["solo"]
    assert any(jax_got[rid] != want for rid, want in s["solo"].items())
