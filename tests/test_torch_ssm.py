"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) and the two
SSM configurations, mamba2-370m (attention-free) and zamba2-1.2b (Mamba-2
blocks and one shared attention block), against the JAX package at
``reduced()`` in float32, on the JAX ``init`` weights bridged through
numpy (biases, norm scales and the SSM's ``conv_b``, ``dt_bias`` and
``d_skip`` perturbed, so that their paths are compared too).

- ``ssd_chunked`` and ``ssd_step`` against JAX's to 2e-6, and both against
  a float64 naive recurrence, as ``tests/test_ssm.py`` holds JAX's.
- ``ssm_apply`` in every call shape to 1e-5: a prefill without a cache,
  a prefill into a cache (at lengths that are and are not multiples of
  the chunk) and a one-token decode; outputs, conv windows and states.
- The masked prefill: rows of mixed length in one right-padded call equal
  JAX's ``ssm_apply`` on each row alone at its own length (outputs at the
  real positions, final state, conv tail).
- The seeded init's tree against JAX's ``init_lm``.
- The models' logits against JAX's to 1e-4: the cache-free forward, the
  dense prefill and decode steps, the paged prefill and decode steps (the
  SSM caches to 1e-5); and prefill + decode against the full forward.

JAX runs jitted (twice as fast as eager here)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro.models.model_zoo import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.init import (cast_for_serving, init_params,
                                     serves_in_float32)
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import forward, logits_fn

torch.set_num_threads(1)

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
CORE_TOL = dict(rtol=2e-6, atol=2e-6)
NAIVE_TOL = dict(rtol=2e-3, atol=2e-3)      # tests/test_ssm.py's
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
N_PAGES, PS, MAX_LEN = 16, 8, 32
PERTURBED = ("b", "scale", "conv_b", "dt_bias", "d_skip")


def naive_recurrence(xdt, a, b, c, state=None):
    """float64 h_t = exp(a_t) h_{t-1} + x_t B_t^T, y_t = h_t C_t."""
    bs, l, h, p = xdt.shape
    hg = h // b.shape[2]
    state = (np.zeros((bs, h, p, b.shape[3])) if state is None
             else np.asarray(state, np.float64))
    ys = np.zeros((bs, l, h, p))
    for t in range(l):
        bh = np.repeat(b[:, t], hg, axis=1)
        ch = np.repeat(c[:, t], hg, axis=1)
        state = (state * np.exp(a[:, t])[:, :, None, None]
                 + xdt[:, t][..., None] * bh[:, :, None, :])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, ch)
    return ys, state


def _core_inputs(rng, bs, l, h, p, g, n):
    f = np.float32
    return (rng.standard_normal((bs, l, h, p)).astype(f) * 0.5,
            -np.abs(rng.standard_normal((bs, l, h))).astype(f) * 0.5,
            rng.standard_normal((bs, l, g, n)).astype(f) * 0.5,
            rng.standard_normal((bs, l, g, n)).astype(f) * 0.5)


@pytest.mark.parametrize("l,chunk,seeded", [(32, 8, False), (29, 8, False),
                                            (13, 4, True)])
def test_ssd_chunked_matches_jax_and_recurrence(l, chunk, seeded):
    rng = np.random.default_rng(l)
    xdt, a, b, c = _core_inputs(rng, 2, l, 4, 8, 2, 16)
    init = (rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
            if seeded else None)
    jy, jstate = jax.jit(jax_ssm.ssd_chunked, static_argnums=4)(
        xdt, a, b, c, chunk, None if init is None else jnp.asarray(init))
    ty, tstate = ssm.ssd_chunked(
        *map(torch.from_numpy, (xdt, a, b, c)), chunk,
        None if init is None else torch.from_numpy(init))
    assert ty.dtype == torch.float32 and tstate.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **CORE_TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                               **CORE_TOL)
    y64, s64 = naive_recurrence(*(v.astype(np.float64)
                                  for v in (xdt, a, b, c)), init)
    np.testing.assert_allclose(ty.numpy(), y64, **NAIVE_TOL)
    np.testing.assert_allclose(tstate.numpy(), s64, **NAIVE_TOL)


def test_ssd_step_matches_jax_and_chunked_tail():
    """The recurrence continues the chunked final state exactly as JAX's
    does, and as the chunked call over one more token."""
    rng = np.random.default_rng(1)
    bs, l, h, p, g, n = 2, 16, 4, 4, 2, 8
    x = rng.standard_normal((bs, l + 1, h, p)).astype(np.float32) * 0.4
    dt = (np.abs(rng.standard_normal((bs, l + 1, h))) * 0.4
          + 0.1).astype(np.float32)
    a_neg = (-np.abs(rng.standard_normal(h)) - 0.1).astype(np.float32)
    b = rng.standard_normal((bs, l + 1, g, n)).astype(np.float32) * 0.4
    c = rng.standard_normal((bs, l + 1, g, n)).astype(np.float32) * 0.4
    xdt, a = x * dt[..., None], dt * a_neg
    t = torch.from_numpy
    _, state_l = ssm.ssd_chunked(t(xdt[:, :l]), t(a[:, :l]), t(b[:, :l]),
                                 t(c[:, :l]), 4)
    y_full, _ = ssm.ssd_chunked(t(xdt), t(a), t(b), t(c), 4)
    new_state, y_step = ssm.ssd_step(state_l, t(x[:, l]), t(dt[:, l]),
                                     t(a_neg), t(b[:, l]), t(c[:, l]))
    jstate, jy = jax.jit(jax_ssm.ssd_step)(
        jnp.asarray(state_l.numpy()), x[:, l], dt[:, l], a_neg, b[:, l],
        c[:, l])
    np.testing.assert_allclose(y_step.numpy(), np.asarray(jy), **CORE_TOL)
    np.testing.assert_allclose(new_state.numpy(), np.asarray(jstate),
                               **CORE_TOL)
    np.testing.assert_allclose(y_step.numpy(), y_full[:, l].numpy(),
                               **NAIVE_TOL)
    y64, s64 = naive_recurrence(xdt.astype(np.float64),
                                a.astype(np.float64), b.astype(np.float64),
                                c.astype(np.float64))
    np.testing.assert_allclose(y_step.numpy(), y64[:, l], **NAIVE_TOL)
    np.testing.assert_allclose(new_state.numpy(), s64, **NAIVE_TOL)


def _perturbed(tree, rng):
    """Every bias, norm scale, conv bias, dt bias and skip moved off its
    init value."""
    if isinstance(tree, dict):
        return {k: (_perturbed(v, rng) if isinstance(v, (dict, list)) else
                    (v + 0.1 * rng.standard_normal(v.shape)).astype(
                        np.float32) if k in PERTURBED else v)
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
    return (cfg, jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
            Model(cfg), params_from_numpy(tree, device="cpu"))


def _block(params):
    """The first SSM layer's ``ssm`` leaves (layer 0 of segment 0)."""
    leaves = params["segments"][0]["ssm"]
    return jax.tree_util.tree_map(lambda v: v[0], leaves)


def _same_cache(tc, jc):
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc.conv),
                               **TOL)
    np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc.state),
                               **TOL)


@pytest.mark.parametrize("length", [8, 11])
def test_ssm_apply_call_shapes_match_jax(models, length):
    """No cache; a prefill into a zero cache; then a one-token decode over
    it.  ``length`` 8 is the reduced chunk, 11 is not a multiple of it."""
    cfg, jmodel, jparams, _, tparams = models
    jp, tp = _block(jparams), _block(tparams)
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    apply = jax.jit(functools.partial(jax_ssm.ssm_apply, cfg=jmodel.cfg))

    jy, _ = apply(jp, x)
    ty = ssm.ssm_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)

    jc = jax_ssm.init_cache(jmodel.cfg, 2, jnp.float32)
    tc = ssm.init_cache(cfg, 2, torch.float32, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == {
        "conv": (tuple(jc.conv.shape), torch.float32),
        "state": (tuple(jc.state.shape), torch.float32)}
    jy, jc = apply(jp, x, cache=jc)
    ty = ssm.ssm_apply(tp, torch.from_numpy(x), cfg, cache=tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _same_cache(tc, jc)

    conv, state = tc["conv"], tc["state"]
    jy, jc = apply(jp, x1, cache=jc)
    ty = ssm.ssm_apply(tp, torch.from_numpy(x1), cfg, cache=tc)
    assert tc["conv"] is conv and tc["state"] is state    # in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _same_cache(tc, jc)


def test_bf16_cache_dtypes_are_jax_init_cache():
    cfg = get_config("mamba2-370m").reduced()
    jc = jax_ssm.init_cache(jax_get_config("mamba2-370m").reduced(), 3)
    tc = ssm.init_cache(cfg, 3, torch.bfloat16, "cpu")
    assert tc["conv"].dtype == torch.bfloat16 and jc.conv.dtype == jnp.bfloat16
    assert tc["state"].dtype == torch.float32 and jc.state.dtype == jnp.float32
    assert tuple(tc["conv"].shape) == jc.conv.shape
    assert tuple(tc["state"].shape) == jc.state.shape


def test_masked_prefill_equals_each_row_alone(models):
    """Rows of 3, 8, 5, 11 and 1 tokens, right-padded to 16 with token
    embeddings that are not zero: the outputs at each row's real positions,
    its final state and its conv tail equal JAX's ``ssm_apply`` on that
    row alone at its own length (into a zero cache)."""
    cfg, jmodel, jparams, _, tparams = models
    jp, tp = _block(jparams), _block(tparams)
    lens = [3, 8, 5, 11, 1]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((len(lens), 16, cfg.d_model)).astype(np.float32)
    tc = ssm.init_cache(cfg, len(lens), torch.float32, "cpu")
    tc["state"].normal_()          # a prefill starts from zero regardless
    tc["conv"].normal_()
    ty = ssm.ssm_apply(tp, torch.from_numpy(x), cfg, cache=tc,
                       lengths=torch.tensor(lens))
    apply = jax.jit(functools.partial(jax_ssm.ssm_apply, cfg=jmodel.cfg))
    for i, n in enumerate(lens):
        jy, jc = apply(jp, x[i:i + 1, :n],
                       cache=jax_ssm.init_cache(jmodel.cfg, 1, jnp.float32))
        np.testing.assert_allclose(ty[i:i + 1, :n].numpy(), np.asarray(jy),
                                   **TOL)
        _same_cache({k: v[i:i + 1] for k, v in tc.items()}, jc)


def test_init_params_match_jax_tree(models):
    """The tree's layout, shapes and dtypes are ``init_lm``'s (shared
    segments ``{}``, one unstacked ``shared_block``), ``a_log`` is JAX's
    ``log(linspace(1, 16, H))`` in every layer, and serving keeps
    ``a_log`` and ``dt_bias`` in float32."""
    cfg, jmodel, jparams, _, _ = models
    ttree = init_params(cfg, 3, device="cpu")
    jl, jdef = jax.tree_util.tree_flatten(jparams)
    tl, tdef = jax.tree_util.tree_flatten(ttree)
    assert jdef == tdef
    for a, t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape)
        assert t.dtype == torch.float32 and a.dtype == jnp.float32
    jseg, tseg = jparams["segments"][0]["ssm"], ttree["segments"][0]["ssm"]
    np.testing.assert_allclose(tseg["a_log"].numpy(),
                               np.asarray(jseg["a_log"]), rtol=1e-6)
    assert (cfg.shared_attn_every > 0) == ("shared_block" in ttree)
    served = cast_for_serving(ttree, torch.bfloat16)["segments"][0]["ssm"]
    assert served["a_log"].dtype == served["dt_bias"].dtype == torch.float32
    assert served["conv_w"].dtype == served["in_xbc"]["w"].dtype \
        == torch.bfloat16
    assert serves_in_float32(("segments", "ssm", "norm", "scale"))


def test_cache_free_forward_matches_jax(models):
    cfg, jmodel, jparams, _, tparams = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 13))
    jh, _, _ = jax.jit(functools.partial(
        jax_transformer.forward, cfg=jmodel.cfg, dtype=jnp.float32))(
            jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    th, _ = forward(tparams, {"tokens": torch.from_numpy(toks)}, cfg,
                    dtype=torch.float32)
    np.testing.assert_allclose(
        logits_fn(tparams, th, cfg).numpy(),
        np.asarray(jax_transformer.logits_fn(jparams, jh, jmodel.cfg)),
        **LOGIT_TOL)


def _same_caches(jc, tc, live):
    """SSM leaves whole; attention stripes or pools on their live rows."""
    for js, ts in zip(jc, tc):
        if isinstance(js, jax_ssm.SsmCache):
            np.testing.assert_allclose(ts["conv"].numpy(),
                                       np.asarray(js.conv), **TOL)
            np.testing.assert_allclose(ts["state"].numpy(),
                                       np.asarray(js.state), **TOL)
        else:
            for name in ("k", "v"):
                np.testing.assert_allclose(ts[name][live].numpy(),
                                           np.asarray(js[name]), **TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serving_call_shapes_match_jax(models, layout):
    """A prefill of 12-token prompts (no row padded, so JAX's arithmetic),
    then three one-token decode steps; logits to 1e-4, caches to 1e-5."""
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(2)
    b, plen = 3, 12
    prompts = rng.integers(0, cfg.vocab, size=(b, plen)).astype(np.int32)
    last = np.full((b,), plen - 1, np.int32)
    if layout == "paged":
        tbl = rng.permutation(N_PAGES)[:b * 4].reshape(b, 4).astype(np.int32)
        jt, tt = jnp.asarray(tbl), torch.from_numpy(tbl)
        jc = jmodel.init_paged_caches(b, N_PAGES, PS, jnp.float32)
        tc = tmodel.init_paged_caches(b, N_PAGES, PS, torch.float32,
                                      device="cpu")
        jl, jc = jax.jit(jmodel.prefill_paged, static_argnames="dtype")(
            jparams, {"tokens": jnp.asarray(prompts)}, jc, jt,
            last_pos=last, dtype=jnp.float32)
        tl, tc = tmodel.prefill_paged(
            tparams, {"tokens": torch.from_numpy(prompts)}, tc, tt,
            dtype=torch.float32, last_pos=torch.from_numpy(last))
        live = (slice(None), slice(0, N_PAGES))
        kw_j, kw_t = dict(pages=jt), dict(pages=tt)
    else:
        jl, jc = jax.jit(jmodel.prefill, static_argnums=2,
                         static_argnames="dtype")(
            jparams, {"tokens": jnp.asarray(prompts)}, MAX_LEN,
            dtype=jnp.float32, last_pos=last)
        tl, tc = tmodel.prefill(tparams,
                                {"tokens": torch.from_numpy(prompts)},
                                MAX_LEN, dtype=torch.float32,
                                last_pos=torch.from_numpy(last))
        live = (slice(None), slice(None), slice(0, MAX_LEN))
        kw_j = kw_t = {}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _same_caches(jc, tc, live)
    step = jax.jit(jmodel.decode_step, static_argnames="dtype")
    depth = np.full((b,), plen, np.int32)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
        jl, jc = step(jparams, jnp.asarray(tok), jc, jnp.asarray(depth),
                      dtype=jnp.float32, **kw_j)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc,
                                    torch.from_numpy(depth),
                                    dtype=torch.float32, **kw_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _same_caches(jc, tc, live)
        depth = depth + 1


def test_prefill_then_decode_matches_full_forward(models):
    """The port's counterpart of ``test_models_smoke.py``'s cache check:
    prefill 7 tokens, decode the 8th, against one forward over all 8."""
    cfg, _, _, tmodel, tparams = models
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 8)))
    hidden, _ = forward(tparams, {"tokens": toks}, cfg, dtype=torch.float32)
    full = logits_fn(tparams, hidden, cfg)
    _, caches = tmodel.prefill(tparams, {"tokens": toks[:, :7]}, 8,
                               dtype=torch.float32)
    step, _ = tmodel.decode_step(tparams, toks[:, 7:8], caches,
                                 torch.full((2,), 7, dtype=torch.int32),
                                 dtype=torch.float32)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 7].numpy(),
                               **LOGIT_TOL)
