"""End-to-end serving: the port's continuous batcher against the JAX
``Batcher`` on the same float32 weights at qwen2-0.5b ``reduced()``, in
both KV layouts (``ServeConfig(paged=True)`` and the dense default): more
requests than slots (refills mid-run) and an EOS id that retires requests
mid-batch.  Greedy streams must be equal; a difference is accepted only
at a logit near-tie (the two candidate tokens' logits within 1e-4 of each
other), which the test then shows.  Also: the port's dense and paged
batchers against each other and against the port's step-by-step dense
oracle, sampling, configuration guards, the CLI entry point, and a
subprocess proof that the port imports neither JAX nor ``repro``."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import param as pm
from repro.models.model_zoo import Model as JaxModel
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import sample_tokens as jax_sample_tokens
from repro.serve.scheduler import Batcher as JaxBatcher
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import forward, logits_fn
from repro_torch.serve.engine import ServeConfig, sample_tokens
from repro_torch.serve.reference import reference_decode
from repro_torch.serve.scheduler import Batcher

torch.set_num_threads(1)

NEAR_TIE = 1e-4
MAX_NEW = 10
SCFG = dict(max_len=64, batch=3, sync_every=4, page_size=8)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-0.5b").reduced()
    jmodel = JaxModel(jax_get_config("qwen2-0.5b").reduced())
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(jmodel.init(jax.random.key(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(7)
    requests = [(i, rng.integers(0, cfg.vocab,
                                 size=int(rng.integers(3, 12))).tolist())
                for i in range(7)]
    model = Model(cfg)
    scfg = ServeConfig(dtype=torch.float32, **SCFG)
    free = reference_decode(model, tparams, scfg, requests, MAX_NEW)
    eos = free[1][3]        # retires request 1 (at least) mid-stream
    return cfg, jmodel, jparams, model, tparams, requests, eos


def _port_run(model, params, requests, eos, **kw):
    b = Batcher(model, params, ServeConfig(dtype=torch.float32,
                                           **{**SCFG, **kw}), eos_id=eos)
    for rid, p in requests:
        b.submit(rid, p)
    return b.run(max_new=MAX_NEW), b


def _assert_same_or_near_tie(cfg, params, prompt, got, want):
    """Equal streams, or the first difference sits at a near-tie of the
    port's own float32 logits after the common prefix."""
    if got == want:
        return
    diff = [j for j in range(min(len(got), len(want))) if got[j] != want[j]]
    assert diff, ("equal prefix, different lengths", got, want)
    i = diff[0]
    toks = torch.tensor([prompt + got[:i]])
    hidden, _ = forward(params, {"tokens": toks}, cfg,
                           dtype=torch.float32)
    logits = logits_fn(params, hidden[:, -1:], cfg)[0, 0]
    gap = abs(float(logits[got[i]] - logits[want[i]]))
    assert gap < NEAR_TIE, (f"streams differ at token {i} without a "
                            f"near-tie (gap {gap})", got, want)


def _jax_run(jmodel, jparams, requests, eos, **kw):
    jb = JaxBatcher(jmodel, jparams,
                    JaxServeConfig(dtype=jnp.float32, **{**SCFG, **kw}),
                    eos_id=eos)
    for rid, p in requests:
        jb.submit(rid, p)
    return jb.run(max_new=MAX_NEW)


def test_port_batcher_matches_jax_batcher(setup):
    cfg, jmodel, jparams, model, tparams, requests, eos = setup
    want = _jax_run(jmodel, jparams, requests, eos, paged=True)
    got, b = _port_run(model, tparams, requests, eos, paged=True)
    assert set(got) == set(want) == {rid for rid, _ in requests}
    assert any(len(v) < MAX_NEW and v[-1] == eos for v in got.values())
    assert b.joins > 1                  # refills happened mid-run
    for rid, prompt in requests:
        _assert_same_or_near_tie(cfg, tparams, prompt, got[rid], want[rid])
    assert b.pool.free_pages == b.pool.n_pages
    b.pool.check()


def test_port_batcher_matches_port_reference(setup):
    """Schedule independence: tiny pool (admission blocks on pages) and a
    different segment length still give the oracle's tokens."""
    cfg, _, _, model, tparams, requests, eos = setup
    want = reference_decode(model, tparams,
                            ServeConfig(dtype=torch.float32, **SCFG),
                            requests, MAX_NEW, eos_id=eos)
    got, b = _port_run(model, tparams, requests, eos, paged=True,
                       total_pages=6, sync_every=3)
    for rid, prompt in requests:
        _assert_same_or_near_tie(cfg, tparams, prompt, got[rid], want[rid])
    assert b.admit_order == [rid for rid, _ in requests]   # FIFO
    b.pool.check()


def test_greedy_sampling_matches_jax():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((6, 40)).astype(np.float32)
    logits[2, 5] = logits[2, 9] = 9.0           # exact tie: first index
    want = jax_sample_tokens(jnp.asarray(logits), jax.random.key(0), 0.0)
    got = sample_tokens(torch.from_numpy(logits), 0.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_sampling_follows_softmax():
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).expand(20000, 4)
    gen = torch.Generator().manual_seed(0)
    draws = sample_tokens(logits, 0.7, gen)
    freq = torch.bincount(draws, minlength=4).float() / draws.numel()
    probs = torch.softmax(logits[0] / 0.7, dim=-1)
    assert (freq - probs).abs().max() < 0.015


def test_config_guards():
    with pytest.raises(ValueError, match="positive"):
        ServeConfig(max_len=32, batch=2, page_size=0)
    cfg = ServeConfig(max_len=33, batch=2, page_size=8)
    assert cfg.max_pages == 5 and cfg.pool_pages == 10
    assert cfg.dtype == torch.bfloat16


def test_oversized_request_rejected(setup):
    _, _, _, model, tparams, _, _ = setup
    b = Batcher(model, tparams, ServeConfig(dtype=torch.float32, paged=True,
                                            **SCFG))
    b.submit(0, [1] * 60)
    with pytest.raises(ValueError, match="exceeds max_len"):
        b.run(max_new=MAX_NEW)


def test_cli_run_on_cpu(capsys):
    from repro_torch.launch.serve import run
    out = run("qwen2-0.5b", reduced=True, requests=3, max_new=4, batch=2,
              paged=True, device="cpu", dtype=torch.float32)
    assert out["tokens"] == 12 and len(out["results"]) == 3
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out


def test_dense_batcher_matches_jax_batcher(setup):
    """The dense default of both packages: ``ServeConfig()`` stripes."""
    cfg, jmodel, jparams, model, tparams, requests, eos = setup
    want = _jax_run(jmodel, jparams, requests, eos)
    got, b = _port_run(model, tparams, requests, eos)
    assert b.pool is None and b.caches[0]["k"].shape[2] == SCFG["max_len"] + 1
    assert set(got) == set(want) == {rid for rid, _ in requests}
    assert any(len(v) < MAX_NEW and v[-1] == eos for v in got.values())
    assert b.joins > 1                  # refills happened mid-run
    assert b.admit_order == [rid for rid, _ in requests]   # FIFO
    for rid, prompt in requests:
        _assert_same_or_near_tie(cfg, tparams, prompt, got[rid], want[rid])


@pytest.mark.parametrize("sync_every", [1, 3, 4])
def test_dense_batcher_matches_paged_batcher_and_reference(setup, sync_every):
    """Port dense vs port paged on the same requests, and both against the
    dense step-by-step oracle: the layout, the row bound (``kv_cap``
    buckets change as slots deepen) and the segment length change no
    token."""
    cfg, _, _, model, tparams, requests, eos = setup
    dense, bd = _port_run(model, tparams, requests, eos,
                          sync_every=sync_every)
    paged, _ = _port_run(model, tparams, requests, eos, paged=True,
                         sync_every=sync_every)
    want = reference_decode(model, tparams,
                            ServeConfig(dtype=torch.float32, **SCFG),
                            requests, MAX_NEW, eos_id=eos)
    assert len({k for k, _ in bd._loops}) == 1
    assert any(cap is not None for _, cap in bd._loops)
    for rid, prompt in requests:
        assert dense[rid] == paged[rid], rid
        _assert_same_or_near_tie(cfg, tparams, prompt, dense[rid], want[rid])


def test_kv_cap_bounds_the_deepest_live_slot(setup):
    """``_kv_cap`` is the power-of-two bucket of the deepest live slot's
    cache length plus the segment's steps; None once it reaches max_len,
    and None with no live slot."""
    _, _, _, model, tparams, _, _ = setup
    b = Batcher(model, tparams, ServeConfig(dtype=torch.float32, **SCFG))
    assert b._kv_cap(4) is None
    b.slot_rid = [0, None, 2]
    b.slot_len = [9, 60, 3]
    assert b._kv_cap(4) == 16           # 9 + 4 -> 16 (slot 1 is free)
    b.slot_len = [13, 0, 3]
    assert b._kv_cap(4) == 32
    b.slot_len = [29, 0, 3]
    assert b._kv_cap(4) is None         # 64 = max_len: read every row


def test_cli_run_dense_on_cpu(capsys):
    from repro_torch.launch.serve import run
    out = run("qwen2-0.5b", reduced=True, requests=3, max_new=4, batch=2,
              device="cpu", dtype=torch.float32)
    assert out["tokens"] == 12 and len(out["results"]) == 3
    assert "dense stripes 2x64" in capsys.readouterr().out


_BLOCKED = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # "import jax" now raises ImportError
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert all(sys.modules[m] is None for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), *names)
"""


def test_port_imports_no_jax_and_no_repro():
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert int(names[0]) >= 19
    assert {"repro_torch.kernels.decode_attn.kernel",
            "repro_torch.kernels.decode_attn.ops",
            "repro_torch.kernels.decode_attn.ref",
            "repro_torch.serve.reference",
            "repro_torch.launch.profile_serve"} <= set(names[1:])
