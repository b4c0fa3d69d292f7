"""The port's train step and checkpointer against the JAX package's on
the CPU, at ``reduced()`` in float32, from one bridged state.

- ``make_train_step`` against JAX's (jitted) over 5 steps of the same
  batches (the port's ``DataPipeline``, equal to JAX's), on qwen2-0.5b
  and moonshot-v1-16b-a3b, at accum 1, accum 2 and with
  ``compress_grads``.  Losses within 1e-5 relative and grad norms within
  1e-5 (1e-4 compressed) at every step; the final params within
  ``max(1e-4 x the leaf's largest entry, 2e-2 x the sum of the steps'
  learning rates)``.  The second term is Adam's: every entry moves by
  about lr a step whatever its gradient's size, so an entry whose
  gradient is near zero (qwen's key bias, whose gradient the softmax's
  shift invariance cancels but for RoPE) moves by a step that float32
  rounding in another order changes by a few percent of lr (measured 7e-3
  of the summed lr).  With compression, a rounding tie of the int8
  quantizer that the two sides break differently moves that entry's
  gradient by one quantum, which Adam turns into up to a step: there at
  most ``STRAY_SHARE`` of the entries may pass the tolerance, each by no
  more than half the summed lr (measured: up to 45 entries of 329,000
  on moonshot, 1.4e-4 of them, each within 0.21 of the summed lr).  The
  compression itself is held exactly in ``test_torch_train.py``.
- Checkpoints: a state written by JAX's ``Checkpointer`` restores into the
  port's bit for bit, and one written by the port's into JAX's; missing
  keys and wrong shapes raise as in JAX.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.train import optimizer as jax_opt
from repro.train import train_loop as jax_tl
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl

torch.set_num_threads(1)

STEPS, LR = 5, 1e-3
LOSS_RTOL = 1e-5
GNORM_RTOL = {False: 1e-5, True: 1e-4}
PARAM_LR_SHARE = 2e-2
STRAY_SHARE = 1e-3        # compressed: entries past the tolerance


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    jmodel = JaxModel(jax_get_config(arch).reduced())
    tree_np = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jax.jit(jmodel.init)(jax.random.key(0))))
    return jmodel, tree_np


def _as_jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _as_numpy(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("accum,compress", [(1, False), (2, False),
                                            (1, True)])
def test_train_step_follows_jax(arch, accum, compress):
    jmodel, tree_np = _jax_tree(arch)
    ocfg = dict(lr=LR, warmup_steps=2, total_steps=STEPS)
    jcfg = jax_tl.TrainConfig(opt=jax_opt.OptConfig(**ocfg), accum=accum,
                              remat=False, dtype=jnp.float32,
                              compress_grads=compress)
    cfg = tl.TrainConfig(opt=opt.OptConfig(**ocfg), accum=accum,
                         remat=False, dtype=torch.float32,
                         compress_grads=compress)
    jparams = _as_jax(tree_np)
    jstate = {"params": jparams, "opt": jax_opt.init_state(jparams,
                                                           jcfg.opt),
              "ef": (jax.tree_util.tree_map(jnp.zeros_like, jparams)
                     if compress else None)}
    model = Model(get_config(arch).reduced())
    state = tl.make_train_state(model, 0, cfg, device="cpu",
                                params=params_from_numpy(tree_np,
                                                         device="cpu"))
    jstep = jax.jit(jax_tl.make_train_step(jmodel, jcfg))
    step = tl.make_train_step(model, cfg)
    data = DataPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=32,
                                   global_batch=4, seed=1))
    for s in range(STEPS):
        tokens = data.batch_at(s)["tokens"]
        jstate, jm = jstep(jstate, jax_tl.split_microbatches(
            {"tokens": jnp.asarray(tokens)}, accum))
        state, m = step(state, tl.split_microbatches(
            {"tokens": torch.from_numpy(tokens)}, accum))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {s}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=GNORM_RTOL[compress],
                                   err_msg=f"step {s}")
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(state["opt"]["step"]) == STEPS
    lr_sum = sum(float(opt.schedule(s, cfg.opt)) for s in range(STEPS))
    want = dict(tree.paths(_as_numpy(jstate["params"])))
    entries = stray = 0
    for key, got in tree.paths(state["params"]):
        w = want[key].astype(np.float64)
        tol = max(1e-4 * float(np.abs(w).max()), PARAM_LR_SHARE * lr_sum)
        err = np.abs(got.numpy().astype(np.float64) - w)
        entries, stray = entries + err.size, stray + int((err > tol).sum())
        limit = 0.5 * lr_sum if compress else tol
        assert float(err.max()) <= limit, f"{key}: {err.max():.3e}"
    assert stray <= (STRAY_SHARE * entries if compress else 0), stray


def _state_np(arch, seed, ef=False):
    """A JAX-layout train state as numpy: the init's params, random
    moments, step 3, and error feedback or None."""
    _, tree_np = _jax_tree(arch)
    rng = np.random.default_rng(seed)
    rand = lambda a: rng.standard_normal(a.shape).astype(np.float32)  # noqa
    return {"params": jax.tree_util.tree_map(rand, tree_np),
            "opt": {"mu": jax.tree_util.tree_map(rand, tree_np),
                    "nu": jax.tree_util.tree_map(
                        lambda a: np.abs(rand(a)), tree_np),
                    "step": np.asarray(3, np.int32)},
            "ef": jax.tree_util.tree_map(rand, tree_np) if ef else None}


def _assert_states_equal(got: dict, want: dict):
    got_paths, want_paths = dict(tree.paths(got)), dict(tree.paths(want))
    assert sorted(got_paths) == sorted(want_paths)
    for key, w in want_paths.items():
        g = np.asarray(got_paths[key])
        assert g.dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)


@pytest.mark.parametrize("ef", [False, True])
def test_jax_checkpoint_restores_into_the_port(tmp_path, ef):
    saved = _state_np("qwen2-0.5b", 1, ef)
    JaxCheckpointer(tmp_path).save(3, _as_jax(saved),
                                   extra={"data": {"step": 3}})
    template = params_from_numpy(_state_np("qwen2-0.5b", 2, ef),
                                 device="cpu")
    state, manifest = Checkpointer(tmp_path).restore(template)
    assert manifest["step"] == 3 and manifest["extra"]["data"]["step"] == 3
    assert state["opt"]["step"].dtype == torch.int32
    assert (state["ef"] is None) == (not ef)
    _assert_states_equal(tree.tree_map(lambda t: t.numpy(), state), saved)


@pytest.mark.parametrize("ef", [False, True])
def test_port_checkpoint_restores_into_jax(tmp_path, ef):
    saved = _state_np("moonshot-v1-16b-a3b", 3, ef)
    ck = Checkpointer(tmp_path, keep=1)
    ck.save_async(5, params_from_numpy(saved, device="cpu"),
                  extra={"data": {"step": 5}, "arch": "moonshot"})
    ck.wait()
    state, manifest = JaxCheckpointer(tmp_path).restore(
        _as_jax(_state_np("moonshot-v1-16b-a3b", 4, ef)))
    assert manifest["step"] == 5 and manifest["extra"]["arch"] == "moonshot"
    assert manifest["n_arrays"] == len(list(tree.paths(saved)))
    _assert_states_equal(_as_numpy(state), saved)


def test_checkpointer_keeps_the_newest_and_raises_as_jax(tmp_path):
    state = params_from_numpy(_state_np("qwen2-0.5b", 5), device="cpu")
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        ck.save_async(s, state)
        state["opt"]["step"] += 1          # in place: the copy is taken
    ck.wait()
    assert ck.all_steps() == [2, 3]
    got, _ = ck.restore(state, step=2)
    assert int(got["opt"]["step"]) == 4
    missing = dict(state, extra_leaf=torch.zeros(2))
    with pytest.raises(KeyError):
        ck.restore(missing)
    wrong = tree.tree_map(lambda t: t, state)
    wrong["params"]["final_norm"]["scale"] = torch.zeros(3)
    with pytest.raises(ValueError):
        ck.restore(wrong)
    with pytest.raises(TypeError):
        ck.save(9, {"w": torch.zeros(2, dtype=torch.bfloat16)})
