"""The port against the JAX package at the encoder-decoder whisper-tiny
(LayerNorm everywhere, a non-causal encoder over stub audio frames,
cross-attention over the encoder's keys and values) and the vision-prefix
internvl2-26b (stub patch embeddings in place of the first positions of
a GQA decoder), each at ``reduced()`` in float32, on the JAX ``init``
weights bridged through numpy, with every bias, norm scale and LayerNorm
bias moved off its init value so that their paths are compared too.

- ``layernorm`` and ``sinusoidal_positions`` to 1e-6.
- ``encode`` (the sinusoid, the encoder blocks with RoPE at the frame
  positions, ``enc_norm``, ``cross_k``/``cross_v``) and one
  cross-attention ``gqa_apply(kv_override=...)`` to 1e-5.
- ``Model.prefill`` with ``encoder_frames`` or ``vision_embeds``, then 3
  greedy ``decode_step``s with ``extra={"cross_kv": ...}`` (whisper), on
  dense stripes and on pages: logits to 1e-4 and equal greedy tokens.
- ``Model.loss`` and its gradients, with the frames or the vision prefix
  and tokens only: the loss to 1e-5 relative, each gradient leaf to 1e-4
  of its largest entry; whisper's per-layer ``cross`` k and v exactly zero
  on both sides (the cross layers read the model-level ``cross_k`` and
  ``cross_v``).
- Text-only greedy streams of the dense and the paged ``Batcher`` against
  JAX's (the batchers carry no frames and no vision prefix, in either
  package).
- ``launch.train.run("whisper-tiny")`` on the CPU: the loss falls over 12
  steps, and a run with a failure injected ends at the clean run's loss.

The JAX side runs as its own tests run it on the CPU (the XLA attention
path; no Pallas kernel is on the encoder or cross-attention path)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attn import decode_attn_policy
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import param as pm
from repro.models import transformer as jax_transformer
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Batcher as JaxBatcher
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch.train import run as train_run
from repro_torch.models import attention, layers, transformer
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Batcher
from repro_torch.train.train_loop import TrainConfig, loss_and_grads

torch.set_num_threads(1)

ARCHS = ["whisper-tiny", "internvl2-26b"]
TIGHT = dict(rtol=1e-6, atol=1e-6)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4                     # of each leaf's largest entry
N_PAGES, PS, MAX_LEN = 16, 8, 32
B, L = 3, 16                        # L 16 reaches past reduced Tv 8


def _perturbed(node, rng):
    """Every projection bias, norm scale and LayerNorm bias moved off its
    init value."""
    if isinstance(node, dict):
        return {k: (_perturbed(v, rng) if isinstance(v, (dict, list)) else
                    (v + 0.1 * rng.standard_normal(v.shape)).astype(
                        np.float32) if k in ("b", "scale", "bias") else v)
                for k, v in node.items()}
    return [_perturbed(v, rng) for v in node]


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(port config, JAX model, JAX params, port model, port params): the
    JAX ``init`` (key 0), perturbed, on both sides; callers never write
    to the params."""
    jmodel = JaxModel(jax_get_config(arch).reduced())
    tree_np = _perturbed(jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jax.jit(jmodel.init)(jax.random.key(0)))),
        np.random.default_rng(0))
    cfg = get_config(arch).reduced()
    return (cfg, jmodel, jax.tree_util.tree_map(jnp.asarray, tree_np),
            Model(cfg), params_from_numpy(tree_np, device="cpu"))


@pytest.fixture(params=ARCHS)
def models(request):
    return _models(request.param)


def _side_inputs(cfg, rng, b=B) -> dict:
    """Seeded stub frames (whisper) or vision embeddings (internvl2)."""
    if cfg.enc_dec:
        return {"encoder_frames": rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {"vision_embeds": rng.standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)}


def _both(batch: dict):
    """The same numpy batch as JAX arrays and as CPU tensors."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_layernorm_matches_jax():
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((2, 5, 64)) + 1.5).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jax_layers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), 1e-5)
    got = layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def test_sinusoidal_positions_match_jax():
    got = layers.sinusoidal_positions(16, 64)          # reduced whisper
    assert got.dtype == torch.float32 and got.shape == (16, 64)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_layers.sinusoidal_positions(16, 64)),
        **TIGHT)


def test_sinusoidal_positions_at_full_width_match_jax():
    """Whisper's 1,500 x 384 table: the two libraries' float32 ``exp``
    may round a rate one ulp apart, which moves the angle ``pos * rate``
    by up to pos ulps of the rate; each entry is held to 1e-6 plus four
    float32 ulps of its angle."""
    got = layers.sinusoidal_positions(1500, 384).numpy()
    want = np.asarray(jax_layers.sinusoidal_positions(1500, 384))
    rate = np.exp(np.arange(0, 384, 2) * (-np.log(10000.0) / 384))
    angle = np.repeat(np.arange(1500)[:, None] * rate, 2, axis=1)
    slack = 1e-6 + 4 * np.spacing(angle.astype(np.float32))
    assert (np.abs(got - want) <= slack).all()


def test_encode_matches_jax():
    cfg, jmodel, jparams, _, tparams = _models("whisper-tiny")
    frames = _side_inputs(cfg, np.random.default_rng(2))["encoder_frames"]
    jk, jv = jax_transformer.encode(jparams, jnp.asarray(frames), jmodel.cfg)
    tk, tv = transformer.encode(tparams, torch.from_numpy(frames), cfg)
    assert tk.shape == (B, cfg.encoder_seq, cfg.kv_heads,
                        cfg.resolved_head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **MODULE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **MODULE_TOL)


def test_cross_attention_matches_jax():
    """Layer 1's cross branch over given keys and values: the query is not
    rotated (positions past 0 would show it) and no mask applies."""
    cfg, jmodel, jparams, _, tparams = _models("whisper-tiny")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((B, cfg.encoder_seq, cfg.kv_heads,
                               cfg.resolved_head_dim)).astype(np.float32)
          for _ in range(2)]
    jp = jax.tree_util.tree_map(lambda a: a[1],
                                jparams["segments"][0]["cross"])
    tp = tree.tree_map(lambda a: a[1], tparams["segments"][0]["cross"])
    want, _ = jax_attention.gqa_apply(
        jp, jnp.asarray(x), jmodel.cfg, positions=jnp.arange(7) + 5,
        causal=False, kv_override=tuple(jnp.asarray(a) for a in kv))
    got, cache = attention.gqa_apply(
        tp, torch.from_numpy(x), cfg, positions=torch.arange(7) + 5,
        causal=False, kv_override=tuple(torch.from_numpy(a) for a in kv))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def _table(rng, b, pages_per_slot):
    """Disjoint random pages for each slot, sentinel-padded to 4 columns."""
    perm = rng.permutation(N_PAGES)
    tbl = np.full((b, 4), N_PAGES, np.int32)
    for i in range(b):
        tbl[i, :pages_per_slot] = perm[i * pages_per_slot:
                                       (i + 1) * pages_per_slot]
    return tbl


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_and_decode_with_side_inputs_match_jax(models, layout):
    """A ragged prefill with the frames or the vision prefix, then 3
    greedy one-token steps, whisper's with the encoder's ``cross_kv`` as
    ``extra``; each step's logits and greedy tokens."""
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, L)).astype(
        np.int32), **_side_inputs(cfg, rng)}
    plens = np.asarray([L, 11, 13], np.int32)
    jb, tb = _both(batch)
    jextra = textra = None
    if cfg.enc_dec:
        jextra = {"cross_kv": jax_transformer.encode(
            jparams, jb["encoder_frames"], jmodel.cfg)}
        textra = {"cross_kv": transformer.encode(
            tparams, tb["encoder_frames"], cfg)}
    if layout == "paged":
        tbl = _table(rng, B, 4)
        jkw = {"pages": jnp.asarray(tbl)}
        tkw = {"pages": torch.from_numpy(tbl)}
        jl, jc = jax.jit(jmodel.prefill_paged, static_argnames="dtype")(
            jparams, jb, jmodel.init_paged_caches(B, N_PAGES, PS,
                                                  jnp.float32),
            jkw["pages"], dtype=jnp.float32, last_pos=plens - 1)
        tl, tc = tmodel.prefill_paged(
            tparams, tb, tmodel.init_paged_caches(B, N_PAGES, PS,
                                                  torch.float32,
                                                  device="cpu"),
            tkw["pages"], dtype=torch.float32,
            last_pos=torch.from_numpy(plens - 1))
    else:
        jkw, tkw = {}, {}
        jl, jc = jax.jit(jmodel.prefill, static_argnums=2,
                         static_argnames="dtype")(
            jparams, jb, MAX_LEN, dtype=jnp.float32, last_pos=plens - 1)
        tl, tc = tmodel.prefill(tparams, tb, MAX_LEN, dtype=torch.float32,
                                last_pos=torch.from_numpy(plens - 1))
    depth = plens.copy()
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok)
        if step == 3:
            break
        with decode_attn_policy(mode="xla"):
            jl, jc = jax.jit(lambda p, t, c, n, **kw: jmodel.decode_step(
                p, t, c, n, dtype=jnp.float32, extra=jextra, **kw))(
                    jparams, jnp.asarray(tok[:, None]), jc,
                    jnp.asarray(depth), **jkw)
        tl, tc = tmodel.decode_step(
            tparams, torch.from_numpy(tok[:, None]), tc,
            torch.from_numpy(depth), dtype=torch.float32, extra=textra,
            **tkw)
        assert tl.shape == (B, 1, cfg.vocab)
        depth = depth + 1


@pytest.mark.parametrize("inputs", ["side", "tokens"])
def test_loss_and_grads_match_jax(models, inputs):
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 24)).astype(
        np.int32)}
    if inputs == "side":
        batch.update(_side_inputs(cfg, rng, b=2))
    jb, tb = _both(batch)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, dtype=jnp.float32)))(jparams, jb)
    # the train step's own gradients: zeros where the loss never reaches
    loss, grads = loss_and_grads(tmodel, tparams, tb,
                                 TrainConfig(dtype=torch.float32,
                                             remat=False))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    want = dict(tree.paths(jax.tree_util.tree_map(np.asarray, want_grads)))
    got = dict(tree.paths(tree.unflatten(tparams, grads)))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy().astype(np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, key
    if cfg.enc_dec:
        for name in ("k", "v"):
            key = f"segments/0/cross/{name}/w"
            assert not want[key].any() and not got[key].any()
        if inputs == "side":         # the encoder is on the loss's path
            for key in ("cross_k/w", "encoder/mlp/wo/w"):
                assert np.abs(want[key]).max() > 0, key


@pytest.mark.parametrize("paged", [False, True])
def test_text_only_batcher_streams_match_jax_batcher(models, paged):
    """Five requests of 3-13 tokens on 2 slots, text only: equal greedy
    streams, refills included."""
    cfg, jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(6)
    requests = [(i, rng.integers(0, cfg.vocab, size=int(n)).tolist())
                for i, n in enumerate(rng.integers(3, 14, size=5))]
    base = dict(max_len=48, batch=2, sync_every=4, page_size=PS,
                paged=paged)
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


def test_train_whisper_loss_falls_and_recovers(tmp_path):
    """12 steps of ``launch.train.run`` at ``reduced()``: the loss falls,
    as JAX's ``launch/train.py`` is asked to; a run with a failure at step 7 restores its step-5
    checkpoint and ends at the clean run's loss."""
    out = train_run("whisper-tiny", steps=12, batch=4, seq=64, reduced=True,
                    lr=3e-3, log_every=100, device="cpu")
    losses = out["losses"]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.05, (losses[0], losses[-1])
    kw = dict(steps=10, batch=2, seq=32, reduced=True, lr=1e-3,
              ckpt_every=5, log_every=100, device="cpu")
    clean = train_run("whisper-tiny", ckpt_dir=str(tmp_path / "a"), **kw)
    faulty = train_run("whisper-tiny", ckpt_dir=str(tmp_path / "b"),
                       fail_at=(7,), **kw)
    assert np.isclose(clean["final_loss"], faulty["final_loss"], rtol=1e-4)
    assert len(faulty["losses"]) == 12
