"""Port model vs the JAX model on the same weights (the JAX ``init_lm``
tree, bridged through numpy), in float32 at qwen2-0.5b ``reduced()``.

The four paged call shapes of serving are compared: whole prefill, suffix
prefill at ``cache_len > 0``, one-token decode, and an Lq = k+1 verify
step; and the dense-stripe ones: prefill, and one-token decode with and
without a ``kv_cap`` bound, including a slot at ``max_len``.  Logits agree
to atol = rtol = 1e-4 (float32, different summation orders; observed
differences are about 1e-6), and the live pages of the KV pools and the
live rows of the stripes agree to 1e-5 after each call.

The JAX side runs as its serving tests run it on the CPU: XLA attention
(through the page table for paged caches), and for one dense decode step
the Pallas decode kernel in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import param as pm
from repro.kernels.decode_attn import decode_attn_policy
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import make_join as jax_make_join
from repro_torch.configs import get_config
from repro_torch.models import attention
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.init import cast_for_serving, init_params
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import forward, logits_fn
from repro_torch.serve.engine import ServeConfig, make_join

torch.set_num_threads(1)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
N_PAGES, PS = 16, 8


@pytest.fixture(scope="module")
def models():
    cfg = get_config("qwen2-0.5b").reduced()
    jmodel = JaxModel(jax_get_config("qwen2-0.5b").reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
    # the JAX init zeroes biases and sets unit norm scales; perturb them
    # so that the bias and scale paths are compared too
    rng = np.random.default_rng(0)
    seg = tree["segments"][0]
    for name in ("q", "k", "v"):
        b = seg["attn"][name]["b"]
        seg["attn"][name]["b"] = (0.1 * rng.standard_normal(b.shape)
                                  ).astype(np.float32)
    for norm in ("norm1", "norm2"):
        s = seg[norm]["scale"]
        seg[norm]["scale"] = (1 + 0.1 * rng.standard_normal(s.shape)
                              ).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    return cfg, jmodel, jparams, Model(cfg), tparams


def _table(rng, b, pages_per_slot):
    """Disjoint random pages for each slot, sentinel-padded to 6 columns."""
    perm = rng.permutation(N_PAGES)
    tbl = np.full((b, 6), N_PAGES, np.int32)
    for i in range(b):
        tbl[i, :pages_per_slot] = perm[i * pages_per_slot:
                                       (i + 1) * pages_per_slot]
    return tbl


def _caches(jmodel, tmodel, b):
    jc = jmodel.init_paged_caches(b, N_PAGES, PS, jnp.float32)
    tc = tmodel.init_paged_caches(b, N_PAGES, PS, torch.float32,
                                  device="cpu")
    return jc, tc


def _same_pools(jc, tc):
    for js, ts in zip(jc, tc):
        for name in ("k", "v"):
            np.testing.assert_allclose(ts[name][:, :N_PAGES].numpy(),
                                       np.asarray(js[name]), **KV_TOL)


def test_prefill_suffix_decode_verify_match_jax(models):
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(1)
    b = 3
    tbl = _table(rng, b, 4)
    jc, tc = _caches(jmodel, tmodel, b)
    f32 = dict(dtype=jnp.float32)

    # 1. whole prefill of ragged prompts padded to one width
    prompts = rng.integers(0, cfg.vocab, size=(b, 9)).astype(np.int32)
    plens = np.asarray([9, 4, 6], np.int32)
    jl, jc = jmodel.prefill_paged(jparams, {"tokens": jnp.asarray(prompts)},
                                  jc, jnp.asarray(tbl), last_pos=plens - 1,
                                  **f32)
    tl, tc = tmodel.prefill_paged(tparams, {"tokens": torch.from_numpy(
        prompts)}, tc, torch.from_numpy(tbl), dtype=torch.float32,
        last_pos=torch.from_numpy(plens - 1))
    assert tl.shape == (b, 1, cfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_pools(jc, tc)

    # 2. suffix prefill at per-slot depth cache_len = plens
    suffix = rng.integers(0, cfg.vocab, size=(b, 5)).astype(np.int32)
    jl, jc = jmodel.prefill_paged(jparams, {"tokens": jnp.asarray(suffix)},
                                  jc, jnp.asarray(tbl),
                                  cache_len=jnp.asarray(plens), **f32)
    tl, tc = tmodel.prefill_paged(tparams, {"tokens": torch.from_numpy(
        suffix)}, tc, torch.from_numpy(tbl), dtype=torch.float32,
        cache_len=torch.from_numpy(plens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_pools(jc, tc)
    depth = plens + 5

    # 3. one-token decode
    tok = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
    jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                jnp.asarray(depth), pages=jnp.asarray(tbl),
                                **f32)
    tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc,
                                torch.from_numpy(depth),
                                dtype=torch.float32,
                                pages=torch.from_numpy(tbl))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_pools(jc, tc)
    depth = depth + 1

    # 4. verify step: Lq = k+1 = 4 tokens at the decode depth
    win = rng.integers(0, cfg.vocab, size=(b, 4)).astype(np.int32)
    jl, jc = jmodel.decode_step(jparams, jnp.asarray(win), jc,
                                jnp.asarray(depth), pages=jnp.asarray(tbl),
                                **f32)
    tl, tc = tmodel.decode_step(tparams, torch.from_numpy(win), tc,
                                torch.from_numpy(depth),
                                dtype=torch.float32,
                                pages=torch.from_numpy(tbl))
    assert tl.shape == (b, 4, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_pools(jc, tc)


def test_sentinel_rows_leave_other_pages_intact(models):
    """A join-style prefill where one row's table is all sentinels: that
    row writes no live page, while the joining row writes its own."""
    cfg, _, _, tmodel, tparams = models
    rng = np.random.default_rng(2)
    b = 2
    tbl = _table(rng, b, 3)
    tc = tmodel.init_paged_caches(b, N_PAGES, PS, torch.float32,
                                  device="cpu")
    for c in tc:
        for name in ("k", "v"):
            c[name].fill_(7.0)
    write = tbl.copy()
    write[1] = N_PAGES
    prompts = rng.integers(0, cfg.vocab, size=(b, 12)).astype(np.int32)
    tmodel.prefill_paged(tparams, {"tokens": torch.from_numpy(prompts)}, tc,
                         torch.from_numpy(write), dtype=torch.float32)
    untouched = [p for p in range(N_PAGES) if p not in tbl[0, :2]]
    for c in tc:
        for name in ("k", "v"):
            assert (c[name][:, untouched] == 7.0).all()
            assert not (c[name][:, tbl[0, :2]] == 7.0).all()


@pytest.mark.parametrize("length", [[0, 5], [14, 3], [20, 0]])
def test_paged_insert_matches_jax_drop_semantics(length):
    """Positions past the table width and sentinel entries drop in JAX;
    in the port they go to the sink page and every live page matches."""
    rng = np.random.default_rng(sum(length))
    n, ps, p = 6, 4, 3
    pool = rng.standard_normal((n, ps, 1, 2)).astype(np.float32)
    vals = rng.standard_normal((2, 7, 1, 2)).astype(np.float32)
    tbl = np.asarray([[2, 0, 5], [4, n, n + 3]], np.int32)   # ids >= n drop
    ln = np.asarray(length, np.int32)
    want = jax_attention._paged_insert(jnp.asarray(pool), jnp.asarray(vals),
                                       jnp.asarray(tbl), jnp.asarray(ln))
    sinked = np.concatenate([pool, np.zeros((1, ps, 1, 2), np.float32)])
    got = attention._paged_insert(torch.from_numpy(sinked),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(tbl), torch.from_numpy(ln))
    np.testing.assert_array_equal(got[:n].numpy(), np.asarray(want))


def test_cache_free_forward_matches_paged_prefill(models):
    """The dense causal core (no cache) and the paged prefill agree."""
    cfg, _, _, tmodel, tparams = models
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 10)))
    hidden, _ = forward(tparams, {"tokens": toks}, cfg,
                           dtype=torch.float32)
    tbl = torch.from_numpy(_table(rng, 2, 2))
    tc = tmodel.init_paged_caches(2, N_PAGES, PS, torch.float32,
                                  device="cpu")
    logits, _ = tmodel.prefill_paged(tparams, {"tokens": toks}, tc, tbl,
                                     dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(),
                               logits_fn(tparams, hidden[:, -1:],
                                         cfg).numpy(), **LOGIT_TOL)


def test_init_matches_jax_shapes_and_scales():
    cfg = get_config("qwen2-0.5b").reduced()
    jtree = pm.unwrap(JaxModel(jax_get_config("qwen2-0.5b").reduced()
                               ).init(jax.random.key(0)))
    ttree = init_params(cfg, 3, device="cpu")
    jl, jdef = jax.tree_util.tree_flatten(jtree)
    tl, tdef = jax.tree_util.tree_flatten(ttree)
    assert jdef == tdef
    for a, t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape)
        assert t.dtype == torch.float32
        std = float(np.std(np.asarray(a)))
        if std > 0:
            assert abs(float(t.std()) - std) < 0.15 * std
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_cast_for_serving_keeps_float32_where_jax_computes_in_float32():
    cfg = get_config("qwen2-0.5b").reduced()
    p = cast_for_serving(init_params(cfg, 0, device="cpu"), torch.bfloat16)
    assert p["embed"]["table"].dtype == torch.float32
    assert p["final_norm"]["scale"].dtype == torch.float32
    seg = p["segments"][0]
    assert seg["norm1"]["scale"].dtype == torch.float32
    assert seg["attn"]["q"]["w"].dtype == torch.bfloat16
    assert seg["attn"]["q"]["b"].dtype == torch.bfloat16
    assert seg["mlp"]["wo"]["w"].dtype == torch.bfloat16


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg).init_paged_caches(1, 4, 8)


@pytest.mark.parametrize("length", [[0, 5], [6, 3], [8, 2], 0, 2, 7])
def test_cache_insert_matches_jax_drop_semantics(length):
    """Per-slot writes at or past max_len drop in JAX; in the port they go
    to the sink row and every live row matches.  An int offset is one
    slice whose start is clamped as ``dynamic_update_slice`` clamps it."""
    rng = np.random.default_rng(len(str(length)))
    max_len = 8
    buf = rng.standard_normal((2, max_len, 1, 2)).astype(np.float32)
    vals = rng.standard_normal((2, 3, 1, 2)).astype(np.float32)
    ln = np.asarray(length, np.int32)
    want = jax_attention._cache_insert(jnp.asarray(buf), jnp.asarray(vals),
                                       jnp.asarray(ln))
    sink = np.full((2, 1, 1, 2), 9.0, np.float32)
    got = attention._cache_insert(
        torch.from_numpy(np.concatenate([buf, sink], axis=1)),
        torch.from_numpy(vals),
        torch.from_numpy(ln) if ln.ndim else int(ln))
    np.testing.assert_array_equal(got[:, :max_len].numpy(), np.asarray(want))
    if ln.ndim == 0:                        # a slice never reaches the sink
        np.testing.assert_array_equal(got[:, max_len].numpy(), sink[:, 0])


def _same_stripes(jc, tc, max_len):
    for js, ts in zip(jc, tc):
        for name in ("k", "v"):
            assert ts[name].shape[2] == max_len + 1         # + sink row
            np.testing.assert_allclose(ts[name][:, :, :max_len].numpy(),
                                       np.asarray(js[name]), **KV_TOL)


def test_dense_prefill_and_decode_match_jax(models):
    """Prefill of ragged prompts into fresh stripes, then decode steps at
    per-slot depths: without a bound, under ``kv_cap`` through the Pallas
    kernel (interpret mode), and with one slot at max_len, whose write JAX
    drops and whose read covers every row under the bound; then a 3-token
    step at per-slot depths."""
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(5)
    b, max_len = 3, 32
    prompts = rng.integers(0, cfg.vocab, size=(b, 9)).astype(np.int32)
    plens = np.asarray([9, 4, 6], np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                            max_len, dtype=jnp.float32, last_pos=plens - 1)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                            max_len, dtype=torch.float32,
                            last_pos=torch.from_numpy(plens - 1))
    assert tl.shape == (b, 1, cfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_stripes(jc, tc, max_len)

    depth = plens.copy()
    for kv_cap, mode in ((None, "xla"), (16, "kernel"), (16, "xla"),
                         (None, "kernel")):
        tok = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
        if kv_cap is None and mode == "kernel":
            depth[1] = max_len              # a retired slot at max_len
        with decode_attn_policy(mode=mode, kv_cap=kv_cap, interpret=True):
            jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                        jnp.asarray(depth),
                                        dtype=jnp.float32)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc,
                                    torch.from_numpy(depth),
                                    dtype=torch.float32, kv_cap=kv_cap)
        assert tl.shape == (b, 1, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _same_stripes(jc, tc, max_len)
        depth = np.minimum(depth + 1, max_len)

    # a 3-token step at per-slot depths: the per-slot masks of the dense
    # core, and per-slot writes of several rows (slot 1's drop at max_len)
    win = rng.integers(0, cfg.vocab, size=(b, 3)).astype(np.int32)
    jl, jc = jmodel.decode_step(jparams, jnp.asarray(win), jc,
                                jnp.asarray(depth), dtype=jnp.float32)
    tl, tc = tmodel.decode_step(tparams, torch.from_numpy(win), tc,
                                torch.from_numpy(depth), dtype=torch.float32)
    assert tl.shape == (b, 3, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_stripes(jc, tc, max_len)


def test_dense_join_writes_only_the_joining_rows(models):
    """The dense join computes and writes the joining slots only: the
    other slots' stripes, tokens, lengths and flags stay bit-for-bit, and
    the joining slot's state and rows match the JAX join's."""
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(6)
    b, max_len = 3, 32
    caches = tmodel.init_caches(b, max_len, torch.float32, device="cpu")
    for c in caches:
        for name in ("k", "v"):
            c[name].copy_(torch.from_numpy(rng.standard_normal(
                c[name].shape).astype(np.float32)))
    before = [{n: c[n].clone() for n in c} for c in caches]
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32)
    lengths = torch.tensor([11, 0, 20], dtype=torch.int32)
    done = torch.tensor([False, True, False])
    remaining = torch.tensor([3, 0, 4], dtype=torch.int32)
    prompt = rng.integers(0, cfg.vocab, size=(1, 8)).astype(np.int32)
    join = make_join(tmodel, ServeConfig(max_len=max_len, batch=b,
                                         dtype=torch.float32), eos_id=None)
    caches, tok2, len2, done2, rem2, first = join(
        tparams, caches, tok, lengths, done, remaining, torch.tensor([1]),
        torch.from_numpy(prompt), torch.tensor([5], dtype=torch.int32),
        torch.tensor([4], dtype=torch.int32), None)
    for c, c0 in zip(caches, before):
        for name in ("k", "v"):
            assert torch.equal(c[name][:, [0, 2]], c0[name][:, [0, 2]])
            assert torch.equal(c[name][:, 1, 8:], c0[name][:, 1, 8:])
    keep = [0, 2]
    assert torch.equal(tok2[keep], tok[keep])
    assert torch.equal(len2[keep], lengths[keep])
    assert torch.equal(done2[keep], done[keep])
    assert torch.equal(rem2[keep], remaining[keep])
    assert first.shape == (1,)

    jjoin = jax_make_join(jmodel, JaxServeConfig(max_len=max_len, batch=b,
                                                 dtype=jnp.float32),
                          eos_id=None)
    prompts = np.zeros((b, 8), np.int32)
    prompts[1] = prompt[0]
    jcaches = jmodel.init_caches(b, max_len, jnp.float32)
    jcaches, jtok, jlen, jdone, jrem, _, jfirst = jjoin(
        jparams, jcaches, jnp.asarray(tok.numpy()),
        jnp.asarray(lengths.numpy()), jnp.asarray(done.numpy()),
        jnp.asarray(remaining.numpy()), jnp.asarray([False, True, False]),
        jnp.asarray(prompts), jnp.asarray([1, 5, 1], jnp.int32),
        jnp.asarray([4, 4, 4], jnp.int32), jax.random.key(0))
    assert int(first[0]) == int(jfirst[1])
    assert int(tok2[1, 0]) == int(jtok[1, 0])
    assert (int(len2[1]), bool(done2[1]), int(rem2[1])) == (
        int(jlen[1]), bool(jdone[1]), int(jrem[1]))
    for js, ts in zip(jcaches, caches):
        for name in ("k", "v"):
            np.testing.assert_allclose(ts[name][:, 1, :5].numpy(),
                                       np.asarray(js[name])[:, 1, :5],
                                       **KV_TOL)


def test_dense_caches_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_config("qwen2-0.5b").reduced()).init_caches(1, 8)
