"""The port against the JAX package at the four configurations it serves
beside qwen2-0.5b and moonshot: starcoder2-3b (gelu, non-gated MLP, qkv
bias, tied embeddings, G 12 at full width), nemotron-4-15b (squared ReLU,
non-gated, an untied 256,000-token read-out, G 6), codeqwen1.5-7b (full
MHA with qkv bias) and deepseek-v3-671b (multi-head latent attention, a
dense prefix and routed experts with a shared one), each at ``reduced()``
in float32, on the JAX ``init`` weights bridged through numpy (biases and
norm scales perturbed, so that their paths are compared too).

- Logits in every call shape to atol = rtol = 1e-4: the cache-free
  forward, the dense-stripe prefill, a one-token decode under a ``kv_cap``
  bound and a 3-token step at per-slot depths, and the paged prefill,
  suffix prefill, one-token decode and the L = k+1 verify.  The live pages
  of the pools and the live rows of the stripes to 1e-5 after each call.
- The dense and the paged ``Batcher`` of both packages on the same
  requests (more than the slots, so refills happen): equal greedy streams
  with every feature off, and on the paged path with the prefix cache,
  chunked prefill and speculation on, with equal prefix and speculation
  statistics.

The JAX side runs as its serving tests run it on the CPU (XLA attention,
through the page table for paged caches)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attn import decode_attn_policy
from repro.models import param as pm
from repro.models import transformer as jax_transformer
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

ARCHS = ["starcoder2-3b", "nemotron-4-15b", "codeqwen1.5-7b",
         "deepseek-v3-671b"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
N_PAGES, PS, MAX_LEN = 16, 8, 32


def _perturbed(tree, rng):
    """Every bias and norm scale of the tree moved off its init value."""
    if isinstance(tree, dict):
        return {k: (_perturbed(v, rng) if isinstance(v, (dict, list)) else
                    (v + 0.1 * rng.standard_normal(v.shape)).astype(
                        np.float32) if k in ("b", "scale") else v)
                for k, v in tree.items()}
    return [_perturbed(v, rng) for v in tree]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    cfg = get_config(arch).reduced()
    jmodel = JaxModel(jax_get_config(arch).reduced())
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jax.jit(jmodel.init)(jax.random.key(0)))),
        np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), tparams


def _table(rng, b, pages_per_slot):
    """Disjoint random pages for each slot, sentinel-padded to 4 columns."""
    perm = rng.permutation(N_PAGES)
    tbl = np.full((b, 4), N_PAGES, np.int32)
    for i in range(b):
        tbl[i, :pages_per_slot] = perm[i * pages_per_slot:
                                       (i + 1) * pages_per_slot]
    return tbl


def _same_caches(jc, tc, live):
    """The live rows (``live`` slices the port's sink away) agree."""
    for js, ts in zip(jc, tc):
        for name in ("k", "v"):
            np.testing.assert_allclose(ts[name][live].numpy(),
                                       np.asarray(js[name]), **KV_TOL)


def test_cache_free_forward_matches_jax(models):
    cfg, jmodel, jparams, _, tparams = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 11))
    jh, _, _ = jax_transformer.forward(jparams, {"tokens": jnp.asarray(
        toks, jnp.int32)}, jmodel.cfg, dtype=jnp.float32)
    th, _ = forward(tparams, {"tokens": torch.from_numpy(toks)}, cfg,
                    dtype=torch.float32)
    np.testing.assert_allclose(
        logits_fn(tparams, th, cfg).numpy(),
        np.asarray(jax_transformer.logits_fn(jparams, jh, jmodel.cfg)),
        **LOGIT_TOL)


def test_paged_call_shapes_match_jax(models):
    """Whole prefill of ragged prompts, suffix prefill at per-slot depth,
    one-token decode and an Lq = 4 verify, through one page table."""
    cfg, jmodel, jparams, tmodel, tparams = models
    # jitted, as one compile a call shape costs less than eager dispatch
    prefill_paged = jax.jit(jmodel.prefill_paged, static_argnames="dtype")
    decode_step = jax.jit(jmodel.decode_step, static_argnames="dtype")
    rng = np.random.default_rng(2)
    b = 3
    tbl = _table(rng, b, 4)
    jc = jmodel.init_paged_caches(b, N_PAGES, PS, jnp.float32)
    tc = tmodel.init_paged_caches(b, N_PAGES, PS, torch.float32,
                                  device="cpu")
    live = (slice(None), slice(0, N_PAGES))
    jt, tt = jnp.asarray(tbl), torch.from_numpy(tbl)
    prompts = rng.integers(0, cfg.vocab, size=(b, 9)).astype(np.int32)
    plens = np.asarray([9, 4, 6], np.int32)
    jl, jc = prefill_paged(jparams, {"tokens": jnp.asarray(prompts)}, jc,
                           jt, last_pos=plens - 1, dtype=jnp.float32)
    tl, tc = tmodel.prefill_paged(
        tparams, {"tokens": torch.from_numpy(prompts)}, tc, tt,
        dtype=torch.float32, last_pos=torch.from_numpy(plens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_caches(jc, tc, live)

    suffix = rng.integers(0, cfg.vocab, size=(b, 5)).astype(np.int32)
    jl, jc = prefill_paged(jparams, {"tokens": jnp.asarray(suffix)}, jc,
                           jt, cache_len=jnp.asarray(plens),
                           dtype=jnp.float32)
    tl, tc = tmodel.prefill_paged(
        tparams, {"tokens": torch.from_numpy(suffix)}, tc, tt,
        dtype=torch.float32, cache_len=torch.from_numpy(plens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_caches(jc, tc, live)

    depth = plens + 5
    for width in (1, 4):                   # decode, then a k = 3 verify
        toks = rng.integers(0, cfg.vocab, size=(b, width)).astype(np.int32)
        jl, jc = decode_step(jparams, jnp.asarray(toks), jc,
                             jnp.asarray(depth), pages=jt,
                             dtype=jnp.float32)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(toks), tc,
                                    torch.from_numpy(depth),
                                    dtype=torch.float32, pages=tt)
        assert tl.shape == (b, width, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _same_caches(jc, tc, live)
        depth = depth + width


def test_dense_call_shapes_match_jax(models):
    """Prefill into fresh stripes, one-token decodes without and under a
    ``kv_cap`` bound (with one slot at max_len, whose write JAX drops),
    then a 3-token step at per-slot depths."""
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(3)
    b = 3
    prompts = rng.integers(0, cfg.vocab, size=(b, 9)).astype(np.int32)
    plens = np.asarray([9, 4, 6], np.int32)
    # jitted, a fresh trace for each policy (JAX reads it at trace time)
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2,
                     static_argnames="dtype")(
        jparams, {"tokens": jnp.asarray(prompts)}, MAX_LEN,
        dtype=jnp.float32, last_pos=plens - 1)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                            MAX_LEN, dtype=torch.float32,
                            last_pos=torch.from_numpy(plens - 1))
    live = (slice(None), slice(None), slice(0, MAX_LEN))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_caches(jc, tc, live)
    depth = plens.copy()
    for kv_cap, width in ((None, 1), (16, 1), (None, 1), (None, 3)):
        if kv_cap is None and depth[0] > 9:
            depth[1] = MAX_LEN               # a retired slot at max_len
        tok = rng.integers(0, cfg.vocab, size=(b, width)).astype(np.int32)
        with decode_attn_policy(mode="xla", kv_cap=kv_cap):
            jl, jc = jax.jit(lambda p, t, c, n: jmodel.decode_step(
                p, t, c, n, dtype=jnp.float32))(
                    jparams, jnp.asarray(tok), jc, jnp.asarray(depth))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc,
                                    torch.from_numpy(depth),
                                    dtype=torch.float32, kv_cap=kv_cap)
        assert tl.shape == (b, width, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _same_caches(jc, tc, live)
        depth = np.minimum(depth + width, MAX_LEN)


FEATURES = {"dense": dict(paged=False), "paged": dict(paged=True),
            "paged features": dict(paged=True, prefix_cache=True,
                                   prefill_chunk=8, speculate_k=3)}


@pytest.mark.parametrize("mode", list(FEATURES))
def test_batcher_streams_match_jax_batcher(models, mode):
    """Five requests behind a shared 16-token prefix on 2 slots: equal
    greedy streams; with the features on, equal prefix and speculation
    statistics, prefix hits and verify steps."""
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(4)
    system = rng.integers(0, cfg.vocab, size=16).tolist()
    requests = [(i, system + rng.integers(0, cfg.vocab, size=int(n)).tolist())
                for i, n in enumerate(rng.integers(2, 14, size=5))]
    base = dict(max_len=64, batch=2, sync_every=4, page_size=PS,
                **FEATURES[mode])
    both = []
    for b in (JaxBatcher(jmodel, jparams,
                         JaxServeConfig(dtype=jnp.float32, **base)),
              Batcher(tmodel, tparams,
                      ServeConfig(dtype=torch.float32, **base))):
        for rid, p in requests:
            b.submit(rid, p)
        b.run(max_new=8)
        both.append(b)
    jb, tb = both
    assert tb.joins > 1
    assert tb.results == jb.results
    if mode == "paged features":
        assert tb.prefix_stats() == jb.prefix_stats()
        assert tb.spec_stats() == jb.spec_stats()
        assert tb.prefix_stats()["hits"] > 0 and tb.spec_stats()["steps"] > 0
        assert tb.chunk_joins == jb.chunk_joins > 0
