"""Port layers vs :mod:`repro.models.layers` on the same numpy inputs, in
float32: rmsnorm (float32 upcast), einsum dense with bias, embed and the
tied float32 read-out, RoPE (split-half, scalar and per-slot positions)
and the gated-SiLU MLP.  Tolerance atol = rtol = 1e-5, except the
read-out and the MLP (longer sums): 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as tl

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def test_config_copy_matches_reference():
    for name in ("qwen2-0.5b",):
        mine, ref = get_config(name), jax_get_config(name)
        assert isinstance(mine, ArchConfig)
        for m, r in ((mine, ref), (mine.reduced(), ref.reduced())):
            assert (m.n_layers, m.d_model, m.n_heads, m.kv_heads, m.d_ff,
                    m.vocab, m.resolved_head_dim, m.qkv_bias,
                    m.tied_embeddings, m.rope_theta, m.norm_eps) == \
                (r.n_layers, r.d_model, r.n_heads, r.kv_heads, r.d_ff,
                 r.vocab, r.resolved_head_dim, r.qkv_bias,
                 r.tied_embeddings, r.rope_theta, r.norm_eps)
    full = get_config("qwen2-0.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab) == \
        (24, 896, 14, 2, 64, 4864, 151_936)


@pytest.mark.parametrize("dtype", [np.float32])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(dtype) * 3
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _both(x)
    js, ts = _both(scale)
    want = jl.rmsnorm({"scale": js}, jx, 1e-6)
    got = tl.rmsnorm({"scale": ts}, tx, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rmsnorm_keeps_bf16_and_upcasts_inside():
    x = torch.randn(2, 3, 16, generator=torch.Generator().manual_seed(0))
    y = tl.rmsnorm({"scale": torch.ones(16)}, x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    ref = tl.rmsnorm({"scale": torch.ones(16)},
                     x.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(y, ref)


@pytest.mark.parametrize("spec,xs,ws,bs", [
    ("btd,dhq->bthq", (2, 3, 16), (16, 4, 8), (4, 8)),
    ("bthq,hqd->btd", (2, 3, 4, 8), (4, 8, 16), None),
    ("btd,df->btf", (1, 7, 16), (16, 32), (32,)),
])
def test_dense(spec, xs, ws, bs):
    rng = np.random.default_rng(len(spec))
    x = rng.standard_normal(xs).astype(np.float32)
    p = {"w": rng.standard_normal(ws).astype(np.float32)}
    if bs:
        p["b"] = rng.standard_normal(bs).astype(np.float32)
    want = jl.dense({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), spec)
    n_in = (len(xs) + len(ws) - len(spec.split("->")[1])) // 2
    got = tl.dense({k: torch.from_numpy(v) for k, v in p.items()},
                   torch.from_numpy(x), n_in)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_and_tied_unembed():
    rng = np.random.default_rng(1)
    table = (0.02 * rng.standard_normal((50, 16))).astype(np.float32)
    toks = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    jt, tt = _both(table)
    emb_j = jl.embed({"table": jt}, jnp.asarray(toks), jnp.float32)
    emb_t = tl.embed({"table": tt}, torch.from_numpy(toks), torch.float32)
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))
    bf = tl.embed({"table": tt}, torch.from_numpy(toks), torch.bfloat16)
    assert torch.equal(bf, tt.to(torch.bfloat16)[torch.from_numpy(toks)])
    h = rng.standard_normal((2, 6, 16)).astype(np.float32)
    want = jl.unembed({"table": jt}, jnp.asarray(h))
    got = tl.unembed({"table": tt}, torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.float32
    got = tl.unembed({"table": tt}, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(tl.rope_freqs(16, theta).numpy(),
                               np.asarray(jl.rope_freqs(16, theta)), **TOL)
    # shared positions, then per-slot positions (continuous batching)
    for pos in (np.arange(5, dtype=np.int32) + 7,
                np.asarray([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13],
                            [300, 301, 302, 303, 304]], np.int32)):
        want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu", "sq_relu"])
def test_mlp(act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    p = {"wi": {"w": rng.standard_normal((16, 32)).astype(np.float32)},
         "wg": {"w": rng.standard_normal((16, 32)).astype(np.float32)},
         "wo": {"w": rng.standard_normal((32, 16)).astype(np.float32) / 6}}
    want = jl.mlp({k: {"w": jnp.asarray(v["w"])} for k, v in p.items()},
                  jnp.asarray(x), act)
    got = tl.mlp({k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()},
                 torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
