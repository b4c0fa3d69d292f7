"""Multi-head latent attention and the blockwise attention core of the
port, against the JAX package (float32, deepseek-v3-671b ``reduced()``).

- ``mla_apply`` against JAX's on the same layer weights (JAX's
  ``init_mla``, bridged) and input, cache-free, over dense stripes and
  over paged pools: outputs and the live cache rows to 1e-5.
- The ports of ``test_mla_cache_is_compressed`` (tests/test_attention.py),
  ``test_paged_mla_matches_dense`` (tests/test_serve_paged.py) and
  ``test_prefix_mla_suffix_prefill`` (tests/test_serve_prefix.py), each
  held to the JAX model's logits on the same weights (1e-4) as well as to
  the port's own other path (2e-5, as there).
- An unallocated table entry reads the sentinel's zero page of an MLA
  pool, never the sink, whatever the sink holds.
- ``_blockwise_attn`` against JAX's at the shapes of
  ``test_blockwise_matches_dense`` (blocks of 64 x 96, set in both
  packages through ``monkeypatch``), with values narrower than the keys as
  MLA's latents are, and ``attention_core`` taking the blockwise branch
  past a patched ``_DENSE_LIMIT`` in both packages: 2e-4 and 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import attention
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
SELF_TOL = dict(rtol=2e-5, atol=2e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, pm.unwrap(tree))


@pytest.fixture(scope="module")
def layer():
    """One MLA layer's weights from JAX's ``init_mla``, both packages."""
    jcfg = jax_get_config(ARCH).reduced()
    tree = _np_tree(jax.jit(lambda k: jax_attention.init_mla(k, jcfg))(
        jax.random.key(1)))
    rng = np.random.default_rng(0)
    for norm in ("dq_norm", "dkv_norm"):
        s = tree[norm]["scale"]
        tree[norm]["scale"] = (1 + 0.1 * rng.standard_normal(s.shape)
                               ).astype(np.float32)
    return (get_config(ARCH).reduced(), jcfg,
            jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def models():
    """The whole reduced model on JAX's ``init`` weights, both packages."""
    jmodel = JaxModel(jax_get_config(ARCH).reduced())
    tree = _np_tree(jax.jit(jmodel.init)(jax.random.key(0)))
    return (get_config(ARCH).reduced(), jmodel,
            jax.tree_util.tree_map(jnp.asarray, tree), Model(
                get_config(ARCH).reduced()),
            params_from_numpy(tree, device="cpu"))


def _x(rng, b, n, d):
    return rng.standard_normal((b, n, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["cache-free", "dense", "paged"])
def test_mla_apply_matches_jax(layer, kind):
    """A 6-token prefill at per-slot depths 0 and 3 (the second a suffix
    over rows written before), then a one-token decode, through each cache
    kind; cache-free one causal call."""
    cfg, jcfg, jp, tp = layer
    rng = np.random.default_rng(1)
    b, n, m = 2, 6, cfg.mla
    x = _x(rng, b, n, cfg.d_model)
    if kind == "cache-free":
        pos = np.arange(n)
        want, _ = jax_attention.mla_apply(jp, jnp.asarray(x), jcfg,
                                          positions=jnp.asarray(pos))
        got, _ = attention.mla_apply(tp, torch.from_numpy(x), cfg,
                                     positions=torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **KV_TOL)
        return
    depth = np.asarray([0, 3], np.int32)
    filled = rng.standard_normal((b, 3, m.kv_lora_rank)).astype(np.float32)
    rope_k = rng.standard_normal((b, 3, m.qk_rope_head_dim)).astype(
        np.float32)
    if kind == "dense":
        s = 16
        jk = np.zeros((b, s, m.kv_lora_rank), np.float32)
        jv = np.zeros((b, s, m.qk_rope_head_dim), np.float32)
        jk[1, :3], jv[1, :3] = filled[1], rope_k[1]
        tk = np.concatenate([jk, np.zeros_like(jk[:, :1])], axis=1)
        tv = np.concatenate([jv, np.zeros_like(jv[:, :1])], axis=1)

        def jcache(k, v, ln):
            return jax_attention.KVCache(k, v, ln)

        def tcache(k, v, ln):
            return attention.KVCache(k, v, ln)
        live = (slice(None), slice(0, s))
    else:
        n_pages, ps = 8, 4
        table = np.asarray([[5, 2, 7, n_pages], [0, 6, 3, n_pages]],
                           np.int32)
        jk = np.zeros((n_pages, ps, m.kv_lora_rank), np.float32)
        jv = np.zeros((n_pages, ps, m.qk_rope_head_dim), np.float32)
        jk[0, :3], jv[0, :3] = filled[1], rope_k[1]
        tk = np.concatenate([jk, np.zeros_like(jk[:2])])
        tv = np.concatenate([jv, np.zeros_like(jv[:2])])

        def jcache(k, v, ln):
            return jax_attention.PagedKVCache(k, v, jnp.asarray(table), ln)

        def tcache(k, v, ln):
            return attention.PagedKVCache(k, v, torch.from_numpy(table), ln)
        live = (slice(0, n_pages),)
    jc = jcache(jnp.asarray(jk), jnp.asarray(jv), jnp.asarray(depth))
    tc = tcache(torch.from_numpy(tk), torch.from_numpy(tv),
                torch.from_numpy(depth))
    for width in (n, 1):
        x = _x(rng, b, width, cfg.d_model)
        pos = depth[:, None] + np.arange(width)[None, :]
        want, jc = jax_attention.mla_apply(jp, jnp.asarray(x), jcfg,
                                           positions=jnp.asarray(pos),
                                           cache=jc)
        got, tc = attention.mla_apply(tp, torch.from_numpy(x), cfg,
                                      positions=torch.from_numpy(pos),
                                      cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **KV_TOL)
        for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(t[live].numpy(), np.asarray(j),
                                       **KV_TOL)
        depth = depth + width
        jc = jcache(jc.k, jc.v, jnp.asarray(depth))
        tc = tcache(tc.k, tc.v, torch.from_numpy(depth))


def test_mla_cache_is_compressed():
    """The caches hold kv_lora + rope dims a token, no head axis, with the
    port's sink row and its sentinel and sink pages; JAX's shapes
    otherwise."""
    cfg = get_config(ARCH).reduced()
    jmodel = JaxModel(jax_get_config(ARCH).reduced())
    model = Model(cfg)
    for tc, jc, extra in (
            (model.init_caches(2, 16, torch.float32, device="cpu"),
             jmodel.init_caches(2, 16, jnp.float32), (0, 0, 1)),
            (model.init_paged_caches(2, 8, 4, torch.float32, device="cpu"),
             jmodel.init_paged_caches(2, 8, 4, jnp.float32), (0, 2, 0))):
        for t, j in zip(tc, jc):
            assert t["k"].shape[-1] == cfg.mla.kv_lora_rank
            assert t["v"].shape[-1] == cfg.mla.qk_rope_head_dim
            for name in ("k", "v"):
                assert t[name].dim() == 4
                assert tuple(t[name].shape) == tuple(
                    n + e for n, e in zip(j[name].shape[:3], extra)
                ) + tuple(j[name].shape[3:])


def test_paged_mla_matches_dense(models):
    """Prefill and one decode step on an identity page table match the
    dense stripes (2e-5, as JAX's test), and both match JAX's logits."""
    cfg, jmodel, jparams, model, params = models
    rng = np.random.default_rng(0)
    b, plen, max_len, ps = 2, 5, 32, 8
    toks = rng.integers(0, cfg.vocab, size=(b, plen)).astype(np.int32)
    n_pages = b * (max_len // ps)
    table = np.arange(n_pages, dtype=np.int32).reshape(b, -1)
    logits_d, caches_d = model.prefill(params, {"tokens": torch.from_numpy(
        toks)}, max_len, dtype=torch.float32)
    caches_p = model.init_paged_caches(b, n_pages, ps, torch.float32,
                                       device="cpu")
    logits_p, caches_p = model.prefill_paged(
        params, {"tokens": torch.from_numpy(toks)}, caches_p,
        torch.from_numpy(table), dtype=torch.float32)
    np.testing.assert_allclose(logits_d[:, -1].numpy(),
                               logits_p[:, -1].numpy(), **SELF_TOL)
    jl, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                 max_len, dtype=jnp.float32)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    nxt = logits_d[:, -1].argmax(-1).to(torch.int32)[:, None]
    ld, _ = model.decode_step(params, nxt, caches_d,
                              torch.full((b,), plen, dtype=torch.int32),
                              dtype=torch.float32)
    lp, _ = model.decode_step(params, nxt, caches_p,
                              torch.full((b,), plen, dtype=torch.int32),
                              dtype=torch.float32,
                              pages=torch.from_numpy(table))
    np.testing.assert_allclose(ld.numpy(), lp.numpy(), **SELF_TOL)
    jl, _ = jmodel.decode_step(jparams, jnp.asarray(nxt.numpy()), jcaches,
                               jnp.asarray(plen, jnp.int32),
                               dtype=jnp.float32)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefix_mla_suffix_prefill(models):
    """Resuming a paged prefill at depth 8 reproduces the one-shot
    prefill's logits (2e-5, as JAX's test), and the suffix call's logits
    match JAX's suffix call's."""
    cfg, jmodel, jparams, model, params = models
    rng = np.random.default_rng(0)
    b, plen, ps = 2, 12, 4
    toks = rng.integers(0, cfg.vocab, size=(b, plen)).astype(np.int32)
    n_pages = b * 4
    table = np.arange(n_pages, dtype=np.int32).reshape(b, -1)
    tt = torch.from_numpy(table)

    def fresh():
        return model.init_paged_caches(b, n_pages, ps, torch.float32,
                                       device="cpu")
    full, _ = model.prefill_paged(params, {"tokens": torch.from_numpy(
        toks)}, fresh(), tt, dtype=torch.float32)
    _, caches = model.prefill_paged(params, {"tokens": torch.from_numpy(
        toks[:, :8])}, fresh(), tt, dtype=torch.float32)
    sfx, _ = model.prefill_paged(
        params, {"tokens": torch.from_numpy(toks[:, 8:])}, caches, tt,
        dtype=torch.float32, cache_len=torch.full((b,), 8,
                                                  dtype=torch.int32))
    np.testing.assert_allclose(full[:, -1].numpy(), sfx[:, -1].numpy(),
                               **SELF_TOL)
    jt = jnp.asarray(table)
    _, jc = jmodel.prefill_paged(
        jparams, {"tokens": jnp.asarray(toks[:, :8])},
        jmodel.init_paged_caches(b, n_pages, ps, jnp.float32), jt,
        dtype=jnp.float32)
    jl, _ = jmodel.prefill_paged(
        jparams, {"tokens": jnp.asarray(toks[:, 8:])}, jc, jt,
        dtype=jnp.float32, cache_len=jnp.full((b,), 8, jnp.int32))
    np.testing.assert_allclose(sfx.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_unallocated_mla_reads_do_not_see_the_sink(models):
    """A retired slot's decode and a suffix prefill read unallocated
    entries (the sentinel id n_pages, and an id past it) of an MLA pool
    after the sink has been written: what they read is the sentinel's
    zero page, so the logits do not depend on the sink's content, and no
    write reaches the sentinel's page."""
    cfg, _, _, model, params = models
    rng = np.random.default_rng(12)
    n_pages, ps = 12, 4
    table = np.asarray([[3, 7, 1, 9], [n_pages, n_pages + 1, n_pages,
                                       n_pages]], np.int32)
    tt = torch.from_numpy(table)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 1)))
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 5)))
    lengths = torch.tensor([9, 6], dtype=torch.int32)
    outs = []
    for junk in (False, True):
        fill = np.random.default_rng(13)
        caches = model.init_paged_caches(2, n_pages, ps, torch.float32,
                                         device="cpu")
        for c in caches:
            for name in ("k", "v"):
                c[name][:, :n_pages] = torch.from_numpy(fill.standard_normal(
                    c[name][:, :n_pages].shape).astype(np.float32))
                if junk:
                    c[name][:, n_pages + 1] = 1e4
        logits, caches = model.decode_step(params, toks, caches, lengths,
                                           dtype=torch.float32, pages=tt)
        first, caches = model.prefill_paged(
            params, {"tokens": prompts}, caches, tt, dtype=torch.float32,
            cache_len=lengths + 1)
        outs.append((logits, first))
        for c in caches:
            for name in ("k", "v"):
                assert not c[name][:, n_pages].any()     # never written
                assert c[name][:, n_pages + 1].any()     # the sink was
    for got, want in zip(*outs):
        assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the blockwise core
# --------------------------------------------------------------------------

def _qkv(rng, b, lq, lk, hq, hkv, d, dv=None):
    return (rng.standard_normal((b, lq, hq, d)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, dv or d)).astype(np.float32))


def _small_blocks(monkeypatch):
    """Blocks of 64 x 96 in both packages: several blocks and a ragged
    tail at these lengths."""
    for mod in (jax_attention, attention):
        monkeypatch.setattr(mod, "BLOCK_Q", 64)
        monkeypatch.setattr(mod, "BLOCK_K", 96)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (6, 1)])
def test_blockwise_matches_jax(monkeypatch, causal, hq, hkv):
    rng = np.random.default_rng(hq * 10 + hkv)
    b, l, d = 2, 256, 32
    q, k, v = _qkv(rng, b, l, l, hq, hkv, d)
    _small_blocks(monkeypatch)
    qg = q.reshape(b, l, hkv, hq // hkv, d)
    want = jax_attention._blockwise_attn(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=0)
    got = attention._blockwise_attn(torch.from_numpy(qg),
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    causal=causal)
    assert got.shape == (b, l, hkv, hq // hkv, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    dense = attention._dense_attn(torch.from_numpy(qg), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_blockwise_with_narrower_values_matches_jax(monkeypatch):
    """Values of width 16 under keys of width 24 (MLA's latent values are
    narrower than its keys), Lq 200 over Lk 150 at an offset."""
    rng = np.random.default_rng(5)
    b, hq, hkv = 2, 6, 1
    q, k, v = _qkv(rng, b, 200, 150, hq, hkv, 24, dv=16)
    _small_blocks(monkeypatch)
    qg = q.reshape(b, 200, hkv, hq, 24)
    want = jax_attention._blockwise_attn(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=-60)
    got = attention._blockwise_attn(torch.from_numpy(qg),
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    causal=True, q_offset=-60)
    assert got.shape == (b, 200, hkv, hq, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_attention_core_goes_blockwise_past_the_dense_limit(monkeypatch):
    """A cache-free call whose Lq x Lk passes ``_DENSE_LIMIT`` (patched
    to 128 x 128 in both packages) takes the blockwise core, as JAX's
    switch does; a call with ``kv_len`` stays dense."""
    rng = np.random.default_rng(6)
    b, l, hq, hkv = 1, 192, 8, 2
    q, k, v = _qkv(rng, b, l, l, hq, hkv, 16, dv=24)
    _small_blocks(monkeypatch)
    for mod in (jax_attention, attention):
        monkeypatch.setattr(mod, "_DENSE_LIMIT", 128 * 128)
    calls = []
    blockwise = attention._blockwise_attn
    monkeypatch.setattr(attention, "_blockwise_attn",
                        lambda *a, **kw: calls.append(1) or blockwise(*a,
                                                                      **kw))
    want = jax_attention.attention_core(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True)
    got = attention.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    assert calls == [1] and got.shape == (b, l, hq, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    attention.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), kv_len=l)
    assert calls == [1]


def test_mla_leaves_serve_in_float32_where_jax_computes_in_float32():
    """Cast for serving, the latent norms' scales and the MTP norm stay
    float32 as every norm scale does; the low-rank projections take the
    serving dtype."""
    from repro_torch.models.init import cast_for_serving, init_params
    p = cast_for_serving(init_params(get_config(ARCH).reduced(), 0,
                                     device="cpu"), torch.bfloat16)
    for seg in p["segments"] + [p["mtp_block"]]:
        attn = seg["attn"]
        assert attn["dq_norm"]["scale"].dtype == torch.float32
        assert attn["dkv_norm"]["scale"].dtype == torch.float32
        for name in ("dq", "uq", "dkv", "kr", "uk", "uv", "o"):
            assert attn[name]["w"].dtype == torch.bfloat16
    assert p["mtp_norm"]["scale"].dtype == torch.float32
    assert p["lm_head"]["w"].dtype == torch.float32
