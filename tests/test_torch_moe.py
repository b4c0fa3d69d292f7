"""The port's MoE path against :mod:`repro.models.moe` and the JAX model
and ``Batcher`` on the same float32 weights (the JAX init, bridged through
numpy), at moonshot-v1-16b-a3b ``reduced()``: 1 dense + 2 MoE layers,
d_model 64, 8 experts, top-2, expert d_ff 64, a shared expert.

The reduced config's ``capacity_factor`` is 8, where no choice drops.  The
tests also run it at 0.5 and 0.05, where choices past an expert's capacity
drop and the rows of a call compete for the slots, so the capacity, the
token-major ranks and the drops are compared too.

- ``route`` and ``moe_apply`` for T = B (a decode step) and T = B x L (a
  prefill): expert ids and per-expert counts exactly, weights,
  probabilities and outputs to 1e-5.
- The model's logits in every call shape of serving (paged whole prefill,
  suffix prefill, decode and verify; dense prefill and decode), to 1e-4
  as in ``test_torch_model.py``.
- The dense join, which prefills every row for a MoE model as JAX does.
- The paged and dense ``Batcher`` streams against the JAX ``Batcher``'s:
  equal greedy streams, with no near-tie allowance.
- The seeded init's layout and the float32 leaves of serving.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import make_join as jax_make_join
from repro.serve.scheduler import Batcher as JaxBatcher
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.init import (cast_for_serving, init_params,
                                     serves_in_float32)
from repro_torch.models.model_zoo import Model
from repro_torch.serve.engine import ServeConfig, make_join
from repro_torch.serve.scheduler import Batcher

torch.set_num_threads(1)

ARCH = "moonshot-v1-16b-a3b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
N_PAGES, PS = 16, 8
MAX_NEW = 10
SCFG = dict(max_len=64, batch=3, sync_every=4, page_size=8)
_MODELS: dict = {}


def _with_capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def _models(factor):
    """(port cfg, JAX model, JAX params, port model, port params) at
    ``factor``, from one JAX init (key 0)."""
    if factor not in _MODELS:
        jcfg = _with_capacity(jax_get_config(ARCH).reduced(), factor)
        jmodel = JaxModel(jcfg)
        tree = jax.tree_util.tree_map(
            np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
        cfg = _with_capacity(get_config(ARCH).reduced(), factor)
        _MODELS[factor] = (cfg, jmodel,
                           jax.tree_util.tree_map(jnp.asarray, tree),
                           Model(cfg), params_from_numpy(tree, device="cpu"))
    return _MODELS[factor]


@pytest.fixture(scope="module")
def moe_params():
    """One MoE layer's parameters (``init_moe``), as numpy."""
    cfg = jax_get_config(ARCH).reduced()
    return jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jax_moe.init_moe(jax.random.key(1), cfg)))


@pytest.mark.parametrize("factor", [8.0, 0.5, 0.05])
@pytest.mark.parametrize("b,length", [(6, 1), (3, 9)],
                         ids=["decode", "prefill"])
def test_route_and_moe_apply_match_jax(moe_params, factor, b, length):
    jcfg = _with_capacity(jax_get_config(ARCH).reduced(), factor)
    cfg = _with_capacity(get_config(ARCH).reduced(), factor)
    rng = np.random.default_rng(int(factor * 100) + b)
    x = (rng.standard_normal((b, length, cfg.d_model)) * 0.5).astype(
        np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, moe_params)
    tp = params_from_numpy(moe_params, device="cpu")

    jw, jids, jprobs = jax_moe.route(jp, jnp.asarray(x.reshape(-1, 64)),
                                     jcfg)
    w, ids, probs = moe.route(tp, torch.from_numpy(x.reshape(-1, 64)), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)

    t, k, e = b * length, cfg.moe.top_k, cfg.moe.n_experts
    cap = moe.capacity(cfg, t)
    assert cap == max(1, int(t * k * factor / e))       # moe.py:181
    slot, buf_tok, counts = moe.dispatch(ids, e, cap)
    chosen = np.bincount(np.asarray(jids).reshape(-1), minlength=e)
    np.testing.assert_array_equal(counts.numpy(), np.minimum(chosen, cap))
    assert int((slot < e * cap).sum()) == int(counts.sum())
    if factor < 1:
        assert counts.sum() < t * k                      # choices dropped

    want, _ = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg, "silu")
    got = moe.moe_apply(tp, torch.from_numpy(x), cfg, "silu")
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _table(rng, b, pages_per_slot):
    perm = rng.permutation(N_PAGES)
    tbl = np.full((b, 6), N_PAGES, np.int32)
    for i in range(b):
        tbl[i, :pages_per_slot] = perm[i * pages_per_slot:
                                       (i + 1) * pages_per_slot]
    return tbl


def _same_caches(jc, tc, rows):
    for js, ts in zip(jc, tc):
        for name in ("k", "v"):
            np.testing.assert_allclose(ts[name][rows].numpy(),
                                       np.asarray(js[name]), **KV_TOL)


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_paged_call_shapes_match_jax(factor):
    """Whole prefill of ragged prompts, suffix prefill, one-token decode
    and a 4-token verify, through the page table."""
    cfg, jmodel, jparams, tmodel, tparams = _models(factor)
    rng = np.random.default_rng(1)
    b = 3
    tbl = _table(rng, b, 4)
    jc = jmodel.init_paged_caches(b, N_PAGES, PS, jnp.float32)
    tc = tmodel.init_paged_caches(b, N_PAGES, PS, torch.float32,
                                  device="cpu")
    live = (slice(None), slice(None, N_PAGES))
    f32 = dict(dtype=jnp.float32)
    prompts = rng.integers(0, cfg.vocab, size=(b, 9)).astype(np.int32)
    plens = np.asarray([9, 4, 6], np.int32)
    jl, jc = jmodel.prefill_paged(jparams, {"tokens": jnp.asarray(prompts)},
                                  jc, jnp.asarray(tbl), last_pos=plens - 1,
                                  **f32)
    tl, tc = tmodel.prefill_paged(tparams, {"tokens": torch.from_numpy(
        prompts)}, tc, torch.from_numpy(tbl), dtype=torch.float32,
        last_pos=torch.from_numpy(plens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_caches(jc, tc, live)

    suffix = rng.integers(0, cfg.vocab, size=(b, 5)).astype(np.int32)
    jl, jc = jmodel.prefill_paged(jparams, {"tokens": jnp.asarray(suffix)},
                                  jc, jnp.asarray(tbl),
                                  cache_len=jnp.asarray(plens), **f32)
    tl, tc = tmodel.prefill_paged(tparams, {"tokens": torch.from_numpy(
        suffix)}, tc, torch.from_numpy(tbl), dtype=torch.float32,
        cache_len=torch.from_numpy(plens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_caches(jc, tc, live)
    depth = plens + 5
    for width in (1, 4):                 # decode, then a verify window
        tok = rng.integers(0, cfg.vocab, size=(b, width)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                    jnp.asarray(depth),
                                    pages=jnp.asarray(tbl), **f32)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc,
                                    torch.from_numpy(depth),
                                    dtype=torch.float32,
                                    pages=torch.from_numpy(tbl))
        assert tl.shape == (b, width, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _same_caches(jc, tc, live)
        depth = depth + width


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_dense_call_shapes_match_jax(factor):
    """Prefill into fresh stripes, then decode steps at per-slot depths,
    without a row bound and under ``kv_cap``."""
    cfg, jmodel, jparams, tmodel, tparams = _models(factor)
    rng = np.random.default_rng(5)
    b, max_len = 3, 32
    live = (slice(None), slice(None), slice(None, max_len))
    prompts = rng.integers(0, cfg.vocab, size=(b, 9)).astype(np.int32)
    plens = np.asarray([9, 4, 6], np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                            max_len, dtype=jnp.float32, last_pos=plens - 1)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                            max_len, dtype=torch.float32,
                            last_pos=torch.from_numpy(plens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_caches(jc, tc, live)
    depth = plens.copy()
    for kv_cap in (None, 16):
        tok = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                    jnp.asarray(depth), dtype=jnp.float32)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc,
                                    torch.from_numpy(depth),
                                    dtype=torch.float32, kv_cap=kv_cap)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _same_caches(jc, tc, live)
        depth = depth + 1


def test_dense_join_prefills_every_row_as_jax_does():
    """At capacity factor 0.5 the joining row's tokens compete with the
    other rows' zero prompts for expert slots: the port's join matches the
    JAX join, whose prefill covers every row, and differs from a prefill
    of the joining row alone.  The other slots' rows stay bit for bit."""
    cfg, jmodel, jparams, tmodel, tparams = _models(0.5)
    rng = np.random.default_rng(6)
    b, max_len, width = 3, 32, 8
    caches = tmodel.init_caches(b, max_len, torch.float32, device="cpu")
    for c in caches:
        for name in ("k", "v"):
            c[name].copy_(torch.from_numpy(rng.standard_normal(
                c[name].shape).astype(np.float32)))
    before = [{n: c[n].clone() for n in c} for c in caches]
    prompt = rng.integers(0, cfg.vocab, size=(1, width)).astype(np.int32)
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32)
    lengths = torch.tensor([11, 0, 20], dtype=torch.int32)
    done = torch.tensor([False, True, False])
    remaining = torch.tensor([3, 0, 4], dtype=torch.int32)
    state0 = [t.clone() for t in (tok, lengths, done, remaining)]
    join = make_join(tmodel, ServeConfig(max_len=max_len, batch=b,
                                         dtype=torch.float32), eos_id=None)
    caches, tok2, len2, done2, rem2, first = join(
        tparams, caches, tok, lengths, done, remaining, torch.tensor([1]),
        torch.from_numpy(prompt), torch.tensor([5], dtype=torch.int32),
        torch.tensor([4], dtype=torch.int32), None)
    for c, c0 in zip(caches, before):
        for name in ("k", "v"):
            assert torch.equal(c[name][:, [0, 2]], c0[name][:, [0, 2]])
            assert torch.equal(c[name][:, 1, width:], c0[name][:, 1, width:])

    jjoin = jax_make_join(jmodel, JaxServeConfig(max_len=max_len, batch=b,
                                                 dtype=jnp.float32),
                          eos_id=None)
    prompts = np.zeros((b, width), np.int32)
    prompts[1] = prompt[0]
    jcaches, jtok, jlen, jdone, jrem, _, jfirst = jjoin(
        jparams, jmodel.init_caches(b, max_len, jnp.float32),
        *(jnp.asarray(t.numpy()) for t in state0),
        jnp.asarray([False, True, False]), jnp.asarray(prompts),
        jnp.asarray([1, 5, 1], jnp.int32), jnp.asarray([4, 4, 4], jnp.int32),
        jax.random.key(0))
    assert int(first[0]) == int(jfirst[1]) == int(tok2[1, 0])
    assert (int(len2[1]), bool(done2[1]), int(rem2[1])) == (
        int(jlen[1]), bool(jdone[1]), int(jrem[1]))
    for js, ts in zip(jcaches, caches):
        for name in ("k", "v"):
            np.testing.assert_allclose(ts[name][:, 1, :5].numpy(),
                                       np.asarray(js[name])[:, 1, :5],
                                       **KV_TOL)
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                           max_len, dtype=jnp.float32,
                           last_pos=jnp.asarray([0, 4, 0]))
    alone, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompt)},
                              width, dtype=torch.float32,
                              last_pos=torch.tensor([4]))
    assert not np.allclose(alone[0].numpy(), np.asarray(jl)[1], **LOGIT_TOL)


def _requests(vocab):
    rng = np.random.default_rng(7)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(3, 12))
                             ).tolist()) for i in range(7)]


def _port_streams(factor, paged):
    cfg, _, _, model, tparams = _models(factor)
    b = Batcher(model, tparams, ServeConfig(dtype=torch.float32,
                                            paged=paged, **SCFG))
    for rid, p in _requests(cfg.vocab):
        b.submit(rid, p)
    return b.run(max_new=MAX_NEW), b


@pytest.mark.parametrize("factor", [8.0, 0.5])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_batcher_streams_match_jax_batcher(factor, paged):
    """More requests than slots (refills mid-run, idle and retired rows in
    every decode step): equal greedy streams, request for request."""
    cfg, jmodel, jparams, _, _ = _models(factor)
    jb = JaxBatcher(jmodel, jparams, JaxServeConfig(
        dtype=jnp.float32, paged=paged, **SCFG))
    for rid, p in _requests(cfg.vocab):
        jb.submit(rid, p)
    want = jb.run(max_new=MAX_NEW)
    got, b = _port_streams(factor, paged)
    assert b.joins > 1
    assert got == want


def test_capacity_drops_change_the_streams():
    """At this size the drops of capacity factor 0.5 are visible in the
    served tokens, so the Batcher comparisons above hold the port to
    them."""
    full, _ = _port_streams(8.0, True)
    tight, _ = _port_streams(0.5, True)
    assert set(full) == set(tight)
    assert full != tight


def test_init_matches_jax_layout_and_scales():
    cfg = get_config(ARCH).reduced()
    jtree = pm.unwrap(JaxModel(jax_get_config(ARCH).reduced()).init(
        jax.random.key(0)))
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


def test_init_in_serving_dtype_equals_cast_of_float32_init():
    """``init_params(dtype=bfloat16)`` is ``cast_for_serving`` of the
    float32 init, bit for bit, with the router, the untied read-out, the
    embedding and the norm scales in float32."""
    cfg = get_config(ARCH).reduced()
    direct = init_params(cfg, 4, device="cpu", dtype=torch.bfloat16)
    cast = cast_for_serving(init_params(cfg, 4, device="cpu"),
                            torch.bfloat16)
    flat_d, _ = jax.tree_util.tree_flatten_with_path(direct)
    flat_c, _ = jax.tree_util.tree_flatten_with_path(cast)
    assert len(flat_d) == len(flat_c)
    kept = set()
    for (path, d), (_, c) in zip(flat_d, flat_c):
        names = tuple(str(getattr(p, "key", "")) for p in path
                      if hasattr(p, "key"))
        assert d.dtype == c.dtype and torch.equal(d, c), names
        want = torch.float32 if serves_in_float32(names) else torch.bfloat16
        assert d.dtype == want, names
        if d.dtype == torch.float32:
            kept.add(names[-2] if names[-1] == "w" else names[-1])
    assert {"router", "lm_head", "table", "scale"} <= kept
    seg = direct["segments"][1]["moe"]
    assert seg["wi"].dtype == seg["shared"]["wo"]["w"].dtype == torch.bfloat16
    assert cast_for_serving(direct, torch.bfloat16)["segments"][1]["moe"][
        "wi"] is seg["wi"]                    # no copy of a cast leaf
