"""The port's sharded paths against the JAX package's and against its own
unsharded paths.

* With no activation policy the act_sharding hooks change nothing, bit
  for bit.
* ``_moe_shard_map`` on a one-rank gloo (1, 1) mesh = JAX's ``moe_apply``
  under its (1, 1) policy (its ``shard_map`` path, 4,096 tokens) within
  2e-4, as ``tests/test_moe_dispatch.py``, and = the port's plain path.
* Two gloo processes on a (1, 2) mesh (experts, heads, mlp and vocab
  split over ``model``, real all-reduces and all-gathers): the
  expert-parallel MoE, the sharded decode step, the gradients of the
  sharded loss (with heads split, and with the sequence split where 3
  heads cannot be) and two sharded train steps' losses equal the
  unsharded port within 1e-5.
* The sharded decode step's float32 tokens and the sharded train step's
  loss and params = JAX's ``jit_decode_step`` / ``jit_train_step`` on a
  (1, 1) mesh (the train step at ``tests/test_torch_train_loop.py``'s
  tolerances).
* ``ElasticPlan.for_devices`` = JAX's; a restore with shardings gives
  DTensors with the shardings' placements and the saved values.
"""
import dataclasses
import json
import multiprocessing
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.distributed.act_sharding import \
    activation_policy as jax_activation_policy
from repro.ft.elastic import ElasticPlan as JaxElasticPlan
from repro.models import moe as jax_moe
from repro.models import param as jpm
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import jit_decode_step
from repro.train import optimizer as jax_opt
from repro.train import train_loop as jax_tl
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.act_sharding import (activation_policy,
                                                  constrain, constrain_btd)
from repro_torch.ft.elastic import ElasticPlan
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.models.moe import _moe_shard_map, moe_apply
from repro_torch.serve.engine import ServeConfig, sharded_decode_step
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl

torch.set_num_threads(1)

QWEN, MOE = "qwen2-0.5b", "moonshot-v1-16b-a3b"
MOE_TOL = 2e-4           # tests/test_moe_dispatch.py's shard_map tolerance
LOSS_RTOL = 1e-5         # tests/test_torch_train_loop.py's tolerances
PARAM_LR_SHARE = 2e-2
SPLIT_TOL = 1e-5         # the (1, 2) gloo runs against the unsharded port


@pytest.fixture
def mesh11():
    """A one-rank gloo process group's (1, 1) mesh, torn down after."""
    from repro_torch.launch.mesh import local_world, make_host_mesh
    with local_world("gloo"):
        yield make_host_mesh()


def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1])


def _jax_params(arch, seed=0):
    jmodel = JaxModel(jax_get_config(arch).reduced())
    return jmodel, jax.tree_util.tree_map(
        np.asarray, jpm.unwrap(jax.jit(jmodel.init)(jax.random.key(seed))))


def _replicated(values, mesh):
    return tree.tree_map(shd.replicated(mesh).place, values)


@pytest.mark.parametrize("arch", [QWEN, MOE, "mamba2-370m"])
def test_no_policy_is_bitwise_the_unsharded_model(arch, monkeypatch):
    from repro_torch.models import attention, layers, moe, ssm, transformer
    cfg = get_config(arch).reduced()
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(0))
    x = torch.ones(2, 3, 4)
    assert constrain(x, ("batch", None, None)) is x
    assert constrain_btd(x) is x
    with torch.no_grad():
        wired, _ = model.prefill(params, {"tokens": tokens}, 16,
                                 dtype=torch.float32)
        loss = model.loss(params, {"tokens": tokens}, dtype=torch.float32)
    for mod in (attention, layers, moe, ssm, transformer):
        if hasattr(mod, "is_sharded"):
            monkeypatch.setattr(mod, "is_sharded", lambda x: False)
    monkeypatch.setattr(transformer, "constrain_btd", lambda x: x)
    with torch.no_grad():
        bare, _ = model.prefill(params, {"tokens": tokens}, 16,
                                dtype=torch.float32)
        bare_loss = model.loss(params, {"tokens": tokens},
                               dtype=torch.float32)
    assert torch.equal(wired, bare) and torch.equal(loss, bare_loss)


def _moe_layer(arch):
    jmodel, tree_np = _jax_params(arch)
    si = next(i for i, s in enumerate(jmodel.cfg.resolved_segments())
              if s.kind.value == "moe")
    layer = jax.tree_util.tree_map(lambda a: a[0],
                                   tree_np["segments"][si]["moe"])
    return jmodel.cfg, layer


@pytest.mark.parametrize("batch,length", [(2, 2048), (2, 8)])
def test_moe_shard_map_matches_jax_and_the_plain_path(batch, length,
                                                      mesh11):
    """4,096 tokens take both packages' shard_map path; 16 tokens JAX's
    global path and the port's expert-parallel form of it."""
    jcfg, layer_np = _moe_layer(MOE)
    cfg = get_config(MOE).reduced()
    rng = np.random.default_rng(5)
    x_np = (rng.standard_normal((batch, length, cfg.d_model)) * 0.5
            ).astype(np.float32)
    with jax_activation_policy(_jax_mesh()):
        jy, jaux = jax_moe.moe_apply(_as_jax(layer_np), jnp.asarray(x_np),
                                     jcfg, "silu")
    layer = params_from_numpy(layer_np, device="cpu")
    x = torch.from_numpy(x_np)
    with torch.no_grad():
        py, paux = moe_apply(layer, x, cfg, "silu", with_aux=True)
        with activation_policy(mesh11):
            xd = shd.place_tree(x, shd.data_shardings(x, mesh11))
            ld = _replicated(layer, mesh11)
            if batch * length >= 4096:
                y, aux = _moe_shard_map(ld, xd, cfg, "silu", mesh11,
                                        with_aux=True)
            else:
                y, aux = moe_apply(ld, xd, cfg, "silu", with_aux=True)
    y, aux = y.full_tensor(), float(aux.full_tensor())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(aux, float(jaux), rtol=1e-5)
    assert float((y - py).abs().max()) <= 1e-6
    assert abs(aux - float(paux)) <= 1e-6


def _as_jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


# ---------------------------------------------------------------------------
# two processes on a (1, 2) mesh
# ---------------------------------------------------------------------------

def _split_worker(rank: int, store_dir: str, out_dir: str) -> None:
    """One rank of the (1, 2) gloo run: every sharded path against the
    unsharded port on the same seeded inputs; its max |diff|s to
    ``out_dir/rank.json``."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import local_world, make_host_mesh
    res = {}
    with local_world("gloo", rank=rank, world_size=2, store_dir=store_dir):
        mesh = make_host_mesh()
        assert tuple(mesh.mesh.shape) == (1, 2)
        # the expert-parallel MoE: shard_map and the global form
        cfg = get_config(MOE).reduced()
        model = Model(cfg)
        params = model.init(0, device="cpu")
        placed = shd.place_tree(params, shd.param_shardings(
            model.abstract_ptree(), mesh))
        layer = tree.tree_map(lambda t: t[0], params["segments"][1]["moe"])
        layer_dt = tree.tree_map(lambda t: t[0],
                                 placed["segments"][1]["moe"])
        gen = torch.Generator().manual_seed(3)
        for name, shape in (("moe_shard_map", (2, 2048)),
                            ("moe_global", (2, 8))):
            x = torch.randn(shape + (cfg.d_model,), generator=gen)
            with torch.no_grad():
                want, waux = moe_apply(layer, x, cfg, "silu", with_aux=True)
                with activation_policy(mesh):
                    y, aux = moe_apply(layer_dt, shd.place_tree(
                        x, shd.data_shardings(x, mesh)), cfg, "silu",
                        with_aux=True)
            res[name] = max(float((y.full_tensor() - want).abs().max()),
                            abs(float(aux.full_tensor()) - float(waux)))
        # the sharded decode step: heads, mlp and vocab split, the cache's
        # sequence split (ctx) gathered and written back
        cfg = get_config(QWEN).reduced()
        model = Model(cfg)
        params = model.init(0, device="cpu")
        prompt = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
        _, caches = model.prefill(params, {"tokens": prompt}, 32,
                                  dtype=torch.float32)
        ref = [{k: v.clone() for k, v in c.items()} for c in caches]
        specs = model.input_specs(ShapeConfig("t", 32, 2, "decode"),
                                  dtype=torch.float32)
        step = sharded_decode_step(
            model, ServeConfig(max_len=32, batch=2, dtype=torch.float32),
            mesh, specs)
        tok = want = prompt[:, -1:].to(torch.int32)
        same = True
        for i in range(3):
            tok, caches = step(params, tok, caches, 8 + i)
            tok = tok.full_tensor()
            with torch.no_grad():
                lg, ref = model.decode_step(
                    params, want, ref, torch.full((2,), 8 + i,
                                                  dtype=torch.int32),
                    dtype=torch.float32)
            want = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            same &= bool(torch.equal(tok, want))
        res["decode_tokens_equal"] = same
        res["decode_caches"] = max(
            float((c[k].full_tensor() - r[k]).abs().max())
            for c, r in zip(caches, ref) for k in r)
        # the gradients through the sharded ops (column/row-parallel and
        # vocab-parallel), then two sharded train steps' losses
        tcfg = tl.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=5),
                              remat=True, dtype=torch.float32)
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32),
                                         generator=gen)}
        _, want = tl.loss_and_grads(model, params, batch, tcfg)
        placed = shd.place_tree(params, shd.param_shardings(
            model.abstract_ptree(), mesh))
        with activation_policy(mesh):
            _, got = tl.loss_and_grads(model, placed, shd.place_tree(
                batch, shd.data_shardings(batch, mesh)), tcfg)
        res["train_grads"] = max(float((a.full_tensor() - b).abs().max())
                                 for a, b in zip(got, want))
        # 3 heads do not split over 2 ranks: context parallelism (the
        # sequence split, causal at each shard's offset)
        ctx_model = Model(dataclasses.replace(cfg, n_heads=3, kv_heads=1))
        ctx_params = ctx_model.init(1, device="cpu")
        _, want = tl.loss_and_grads(ctx_model, ctx_params, batch, tcfg)
        with activation_policy(mesh):
            _, got = tl.loss_and_grads(ctx_model, shd.place_tree(
                ctx_params, shd.param_shardings(ctx_model.abstract_ptree(),
                                                mesh)),
                shd.place_tree(batch, shd.data_shardings(batch, mesh)), tcfg)
        res["ctx_grads"] = max(float((a.full_tensor() - b).abs().max())
                               for a, b in zip(got, want))
        state = tl.make_train_state(model, 0, tcfg, device="cpu")
        ref = tree.tree_map(torch.clone, state)
        sstep = tl.sharded_train_step(model, tcfg, mesh, batch)
        rstep = tl.make_train_step(model, tcfg)
        losses = []
        for _ in range(2):
            state, m = sstep(state, batch)
            ref, rm = rstep(ref, batch)
            losses.append(abs(float(m["loss"].full_tensor())
                              - float(rm["loss"])))
        res["train_loss"] = max(losses)
    pathlib.Path(out_dir, f"{rank}.json").write_text(json.dumps(res))


def test_two_ranks_split_over_model_equal_the_unsharded_port(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    store = tmp_path / "store"
    store.mkdir()
    procs = [ctx.Process(target=_split_worker,
                         args=(r, str(store), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
        assert not p.is_alive() and p.exitcode == 0, p.exitcode
    for r in range(2):
        res = json.loads((tmp_path / f"{r}.json").read_text())
        assert res.pop("decode_tokens_equal") is True
        assert all(v <= SPLIT_TOL for v in res.values()), res


# ---------------------------------------------------------------------------
# the sharded steps against JAX's jitted ones on a (1, 1) mesh
# ---------------------------------------------------------------------------

def test_sharded_decode_step_tokens_equal_jax(mesh11):
    jmodel, tree_np = _jax_params(QWEN)
    jshape = JaxShapeConfig("t", 32, 2, "decode")
    jspecs = jmodel.input_specs(jshape, dtype=jnp.float32)
    jstep = jit_decode_step(jmodel, JaxServeConfig(max_len=32, batch=2,
                                                   dtype=jnp.float32),
                            _jax_mesh(), jspecs)
    jcaches = jmodel.init_caches(2, 32, jnp.float32)
    jtok = jnp.zeros((2, 1), jnp.int32)
    model = Model(get_config(QWEN).reduced())
    specs = model.input_specs(ShapeConfig("t", 32, 2, "decode"),
                              dtype=torch.float32)
    step = sharded_decode_step(model, ServeConfig(max_len=32, batch=2,
                                                  dtype=torch.float32),
                               mesh11, specs)
    params = params_from_numpy(tree_np, device="cpu")
    caches = model.init_caches(2, 32, torch.float32, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for depth in range(2):
        jtok, jcaches = jstep(_as_jax(tree_np), jtok, jcaches,
                              jnp.asarray(depth, jnp.int32), {})
        tok, caches = step(params, tok, caches, depth, {})
        tok = tok.full_tensor()
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_sharded_train_step_follows_jax(mesh11):
    jmodel, tree_np = _jax_params(QWEN)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=4)
    jcfg = jax_tl.TrainConfig(opt=jax_opt.OptConfig(**ocfg), remat=False,
                              dtype=jnp.float32)
    cfg = tl.TrainConfig(opt=opt.OptConfig(**ocfg), remat=False,
                         dtype=torch.float32)
    data = DataPipeline(DataConfig(vocab=jmodel.cfg.vocab, seq_len=32,
                                   global_batch=4, seed=1))
    spec = {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32)}
    jstep = jax_tl.jit_train_step(jmodel, jcfg, _jax_mesh(), spec)
    jparams = _as_jax(tree_np)
    jstate = {"params": jparams, "opt": jax_opt.init_state(jparams,
                                                           jcfg.opt),
              "ef": None}
    model = Model(get_config(QWEN).reduced())
    state = tl.make_train_state(model, 0, cfg, device="cpu",
                                params=params_from_numpy(tree_np,
                                                         device="cpu"))
    step = tl.sharded_train_step(model, cfg, mesh11,
                                 {"tokens": torch.zeros((4, 32),
                                                        dtype=torch.int32)})
    steps = 2
    for s in range(steps):
        tokens = data.batch_at(s)["tokens"]
        with jax_activation_policy(_jax_mesh()):
            jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(m["loss"].full_tensor()),
                                   float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"].full_tensor()),
                                   float(jm["grad_norm"]), rtol=1e-5)
    lr_sum = sum(float(opt.schedule(s, cfg.opt)) for s in range(steps))
    want = dict(tree.paths(jax.tree_util.tree_map(np.asarray,
                                                  jstate["params"])))
    for key, got in tree.paths(state["params"]):
        w = want[key].astype(np.float64)
        tol = max(1e-4 * float(np.abs(w).max()), PARAM_LR_SHARE * lr_sum)
        err = np.abs(got.full_tensor().numpy().astype(np.float64) - w)
        assert float(err.max()) <= tol, f"{key}: {err.max():.3e}"


# ---------------------------------------------------------------------------
# elastic re-mesh and restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefer_pods", [1, 2])
@pytest.mark.parametrize("model_axis", [1, 2, 4, 8, 16])
def test_elastic_plan_equals_jax(model_axis, prefer_pods):
    for n in range(1, 601):
        got = ElasticPlan.for_devices(n, model=model_axis,
                                      prefer_pods=prefer_pods)
        want = JaxElasticPlan.for_devices(n, model=model_axis,
                                          prefer_pods=prefer_pods)
        assert (got.data, got.model, got.pod, got.n_devices) == (
            want.data, want.model, want.pod, want.n_devices), n


def test_restore_with_shardings_places_dtensors(tmp_path, mesh11):
    from torch.distributed.tensor import DTensor
    model = Model(get_config(QWEN).reduced())
    params = model.init(1, device="cpu")
    ck = Checkpointer(tmp_path)
    ck.save(3, params)
    plan = ElasticPlan.for_devices(1)
    assert (plan.data, plan.model, plan.pod) == (1, 1, 1)
    mesh = plan.make_mesh()
    shardings = shd.param_shardings(model.abstract_ptree(), mesh)
    restored, manifest = ck.restore(params, shardings=shardings)
    assert manifest["step"] == 3
    for got, want, sh in zip(tree.leaves(restored), tree.leaves(params),
                             tree.leaves(shardings)):
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == sh.placements
        assert torch.equal(got.full_tensor(), want)
