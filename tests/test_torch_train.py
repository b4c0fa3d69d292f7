"""The port's training pieces against the JAX package's on the CPU, in
float32 at ``reduced()``, from the JAX ``init`` weights bridged through
numpy and inputs drawn from seeded numpy generators.

- ``lm_loss`` on all ten registered configs (next-token cross-entropy
  with the z-loss, deepseek's MTP term, the MoE load-balance term): the
  loss within 1e-5 relative, and every gradient leaf within 1e-4 of that
  leaf's largest entry, against ``jax.grad`` of JAX's ``Model.loss``.
  Both sides sum in float32 in other orders; 1e-4 leaves two decades of
  room over what they differ by here.
- ``chunked_xent`` at a length that is not a multiple of the chunk, with a
  mask, to 1e-6.
- ``route`` and ``aux_load_balance_loss`` on the same inputs.
- ``remat`` on against off: the same loss and gradients.
- ``schedule`` at steps 0, warmup - 1, warmup, mid and total.
- ``apply_updates`` on bridged params (their stacked norm scales pin the
  ``ndim >= 2`` decay), grads and state: params, moments, grad norm and
  lr within 1e-6.
- ``compress_tree`` against JAX's, exactly, on values with rounding ties.
- ``DataPipeline.batch_at`` equal to JAX's for several (seed, step,
  shard).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.distributed import compression as jax_compression
from repro.models import moe as jax_moe
from repro.models import param as pm
from repro.models import transformer as jax_transformer
from repro.models.model_zoo import Model as JaxModel
from repro.train import optimizer as jax_opt
from repro_torch import tree
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.distributed import compression
from repro_torch.models import moe, transformer
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

B, L = 2, 24
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # of each leaf's largest entry


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    """The JAX model and its ``init`` (key 0) as numpy; callers bridge
    copies and never write to the arrays."""
    jmodel = JaxModel(jax_get_config(arch).reduced())
    tree_np = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jax.jit(jmodel.init)(jax.random.key(0))))
    return jmodel, tree_np


def _tokens(vocab, seed=0, b=B, length=L):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, length)).astype(np.int32)


def _port_loss_and_grads(model, params, tokens, **kw):
    flat = tree.leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    loss = model.loss(tree.unflatten(params, live),
                      {"tokens": torch.from_numpy(tokens)},
                      dtype=torch.float32, **kw)
    # a leaf the loss never reaches (whisper's per-layer cross k and v,
    # and with no frames its encoder) gets zeros, as JAX's gradient does
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return float(loss.detach()), tree.unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(flat, grads)])


def _assert_leaves_close(got, want, tol, what):
    want_paths = dict(tree.paths(want))
    got_paths = dict(tree.paths(got))
    assert sorted(got_paths) == sorted(want_paths), what
    for key, w in want_paths.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got_paths[key].detach(), np.float64)
        assert g.shape == w.shape, (what, key)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{what} {key}: {err:.2e} of the leaf's largest"


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    jmodel, tree_np = _jax_tree(arch)
    tokens = _tokens(jmodel.cfg.vocab)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree_np)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, t: jmodel.loss(p, {"tokens": t}, dtype=jnp.float32)))(
            jparams, jnp.asarray(tokens))
    model = Model(get_config(arch).reduced())
    loss, grads = _port_loss_and_grads(
        model, params_from_numpy(tree_np, device="cpu"), tokens)
    assert abs(loss - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss)), (arch, loss, float(want_loss))
    _assert_leaves_close(grads, jax.tree_util.tree_map(np.asarray,
                                                       want_grads),
                         GRAD_TOL, arch)


def test_chunked_xent_ragged_chunks_match_jax():
    jmodel, tree_np = _jax_tree("nemotron-4-15b")      # untied read-out
    cfg = get_config("nemotron-4-15b").reduced()
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, size=(B, 20)).astype(np.int32)
    mask = rng.random((B, 20)) < 0.8
    want = jax_transformer.chunked_xent(
        jax.tree_util.tree_map(jnp.asarray, tree_np), jnp.asarray(hidden),
        jnp.asarray(targets), jmodel.cfg, jnp.asarray(mask), chunk=8)
    params = params_from_numpy(tree_np, device="cpu")
    args = (params, torch.from_numpy(hidden), torch.from_numpy(targets),
            cfg, torch.from_numpy(mask))
    got = transformer.chunked_xent(*args, chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with torch.no_grad():             # the loop without checkpoints
        np.testing.assert_allclose(float(transformer.chunked_xent(
            *args, chunk=8)), float(got), rtol=1e-6)
    # one chunk of the whole length: the same value
    np.testing.assert_allclose(float(transformer.chunked_xent(*args)),
                               float(got), rtol=1e-6)


def test_route_and_aux_loss_match_jax():
    jmodel, tree_np = _jax_tree("moonshot-v1-16b-a3b")
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    moe_np = jax.tree_util.tree_map(lambda a: a[0],
                                    tree_np["segments"][1]["moe"])
    x = np.random.default_rng(4).standard_normal(
        (40, cfg.d_model)).astype(np.float32)
    jw, jids, jprobs = jax_moe.route(
        jax.tree_util.tree_map(jnp.asarray, moe_np), jnp.asarray(x),
        jmodel.cfg)
    want = jax_moe.aux_load_balance_loss(jprobs, jids, cfg.moe.n_experts)
    w, ids, probs = moe.route(params_from_numpy(moe_np, device="cpu"),
                              torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    got = moe.aux_load_balance_loss(probs, ids, cfg.moe.n_experts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b"])
def test_remat_gives_the_same_gradients(arch):
    _, tree_np = _jax_tree(arch)
    model = Model(get_config(arch).reduced())
    tokens = _tokens(model.cfg.vocab, seed=5)
    loss0, g0 = _port_loss_and_grads(
        model, params_from_numpy(tree_np, device="cpu"), tokens)
    loss1, g1 = _port_loss_and_grads(
        model, params_from_numpy(tree_np, device="cpu"), tokens, remat=True)
    assert loss1 == loss0
    for (k, a), (_, b) in zip(tree.paths(g0), tree.paths(g1)):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("step", [0, 9, 10, 55, 100])
def test_schedule_matches_jax(step):
    jcfg = jax_opt.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    cfg = opt.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    want = jax_opt.schedule(jnp.asarray(step, jnp.int32), jcfg)
    got = opt.schedule(torch.tensor(step, dtype=torch.int32), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_apply_updates_matches_jax():
    _, tree_np = _jax_tree("qwen2-0.5b")
    rng = np.random.default_rng(6)
    like = lambda a, s: (s * rng.standard_normal(a.shape)).astype(  # noqa
        np.float32)
    grads = jax.tree_util.tree_map(lambda a: like(a, 0.3), tree_np)
    mu = jax.tree_util.tree_map(lambda a: like(a, 0.01), tree_np)
    nu = jax.tree_util.tree_map(lambda a: np.abs(like(a, 1e-4)), tree_np)
    state = {"mu": mu, "nu": nu, "step": np.asarray(3, np.int32)}
    assert any(p.endswith("norm1/scale") and a.ndim == 2
               for p, a in tree.paths(tree_np))          # stacked [n, d]
    jcfg = jax_opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                             clip_norm=1.0)
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                        clip_norm=1.0)
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa
    want_p, want_s, want_m = jax.jit(jax_opt.apply_updates,
                                     static_argnums=3)(
        as_jax(tree_np), as_jax(grads), as_jax(state), jcfg)
    got_p, got_s, got_m = opt.apply_updates(
        params_from_numpy(tree_np, device="cpu"),
        params_from_numpy(grads, device="cpu"),
        params_from_numpy(state, device="cpu"), cfg)
    for name, got, want in (("params", got_p, want_p),
                            ("mu", got_s["mu"], want_s["mu"]),
                            ("nu", got_s["nu"], want_s["nu"])):
        for (k, g), (_, w) in zip(tree.paths(got), tree.paths(
                jax.tree_util.tree_map(np.asarray, want))):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {k}")
    assert int(got_s["step"]) == int(want_s["step"]) == 4
    assert got_s["step"].dtype == torch.int32
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=1e-6)
    assert float(got_m["grad_norm"]) > 1.0          # the clip is active


def test_compress_tree_matches_jax_exactly():
    rng = np.random.default_rng(7)
    # values on a grid of the scale hit x / scale = k + 0.5 exactly
    ties = (np.arange(-254, 255, dtype=np.float32) * 0.5)
    grads = {"a": ties.reshape(-1, 1)[:508].reshape(4, 127),
             "b": [rng.standard_normal((5, 7)).astype(np.float32),
                   np.zeros((3,), np.float32)]}
    ef = {"a": np.zeros((4, 127), np.float32),
          "b": [rng.standard_normal((5, 7)).astype(np.float32) * 1e-3,
                np.zeros((3,), np.float32)]}
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa
    want_g, want_e = jax_compression.compress_tree(as_jax(grads),
                                                   as_jax(ef))
    got_g, got_e = compression.compress_tree(
        params_from_numpy(grads, device="cpu"),
        params_from_numpy(ef, device="cpu"))
    for got, want in ((got_g, want_g), (got_e, want_e)):
        for (k, g), (_, w) in zip(tree.paths(got), tree.paths(
                jax.tree_util.tree_map(np.asarray, want))):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    q, _ = compression.quantize(torch.from_numpy(grads["a"]))
    jq, _ = jax_compression.quantize(jnp.asarray(grads["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8


@pytest.mark.parametrize("seed,step,n_shards,shard",
                         [(0, 0, 1, 0), (0, 7, 1, 0), (3, 2, 2, 1),
                          (11, 40, 4, 2)])
def test_data_pipeline_matches_jax(seed, step, n_shards, shard):
    kw = dict(vocab=256, seq_len=96, global_batch=8, seed=seed,
              n_shards=n_shards, shard=shard)
    want = JaxDataPipeline(JaxDataConfig(**kw)).batch_at(step)
    got = DataPipeline(DataConfig(**kw)).batch_at(step)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_gemm_function_backward_on_the_plain_version(monkeypatch,
                                                           dtype):
    """The CUDA route's autograd function with its kernels replaced by
    their plain versions (the CPU has no kernel): dxe and dw equal
    autograd through the plain version, dy and the function's xe NaN past
    the counts.  The calls: the forward, then the mask and cast of dy,
    dxe and (bfloat16 past 16 rows) the dw kernel; float32 takes dw from
    ``torch.bmm``.  dxe gets the caller's own w (the same storage: no
    transposed copy)."""
    from repro_torch.kernels.moe_group_gemm import kernel, ops, ref
    calls = []

    def stub(name, fn):
        def run(*args, **kw):
            calls.append((name, args))
            assert all(a.is_contiguous() for a in args
                       if isinstance(a, torch.Tensor))
            return fn(*args, **kw)
        monkeypatch.setattr(kernel, name, run)
    stub("group_gemm_cuda", ref.group_gemm_ref)
    stub("group_gemm_dy_cuda", ref.group_gemm_dy_ref)
    stub("group_gemm_dxe_cuda", ref.group_gemm_dxe_ref)
    stub("group_gemm_dw_cuda",
         lambda xe, dy, cnt: ref.group_gemm_dw_ref(xe, dy, cnt).to(xe.dtype))
    rng = np.random.default_rng(8)
    e, c, d, f = 4, 20, 8, 16
    cnt = torch.tensor([0, 3, 20, 7], dtype=torch.int32)
    live = torch.arange(c)[None, :, None] < cnt[:, None, None]
    xe = (torch.from_numpy(rng.standard_normal((e, c, d))).float()
          * live).to(dtype)
    w = torch.from_numpy(rng.standard_normal((e, d, f))).to(dtype)
    # float32 holding values of the working dtype, as the model's cast of
    # the output to it hands back
    dy = torch.from_numpy(rng.standard_normal((e, c, f))).to(dtype).float()
    dy = torch.where(live, dy, torch.full_like(dy, float("nan")))
    x_nan = torch.where(live, xe, torch.full_like(xe, float("nan")))
    x_nan.requires_grad_()
    wk = w.clone().requires_grad_()
    got = torch.autograd.grad(ops.GroupGemm.apply(x_nan, wk, cnt),
                              (x_nan, wk), dy)
    order = ["group_gemm_cuda", "group_gemm_dy_cuda", "group_gemm_dxe_cuda"]
    if dtype == torch.bfloat16:
        order.append("group_gemm_dw_cuda")
    assert [name for name, _ in calls] == order
    w_dxe = calls[2][1][1]
    assert w_dxe.shape == (e, d, f) and w_dxe.data_ptr() == wk.data_ptr()
    xr, wr = xe.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(ref.group_gemm_ref(xr, wr, cnt), (xr, wr),
                               dy)
    for g, wnt in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), wnt.float(),
                                   rtol=1e-2 if dtype == torch.bfloat16
                                   else 1e-6, atol=1e-5)
    assert bool((got[0][~live.expand(e, c, d)] == 0).all())
