"""DeepSeek-V3 at one chip's share of an expert-parallel layer, on the
CPU in float32 at ``reduced()`` sizes (8 experts in 4 groups, top-2 of
the best 2 groups, 4 held, capacity factor 8, YaRN over the rope dims):

- the ``noaux_tc`` gate against a direct transcription of DeepSeek-V3's
  ``Gate``, with a nonzero correction bias, and with a group that holds
  the single best expert but loses on its best two;
- the share: the routed parts that the shares of a partition of the
  experts compute, with the shared expert counted once, add up to the
  uncut layer's output;
- YaRN's frequencies, tables and softmax scale against the published
  formulas, at DeepSeek-V3's numbers;
- the MLA join attends in key blocks, at each row's depth, as the dense
  core does;
- prefill then paged decode of the model against the benchmark's plain
  reference (``portbench/reference/deepseek_v3.py``), on logits;
- a traced batcher counts the routing choices on held experts on the
  device, serving the untraced batcher's tokens; which models' joins
  compute their joining rows alone (``rows_interact``)."""
import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention, moe
from repro_torch.models.attention import PagedKVCache, mla_apply
from repro_torch.models.init import init_params
from repro_torch.models.layers import (mla_rope_tables, mlp, yarn_freqs,
                                       yarn_mscale)
from repro_torch.models.model_zoo import Model
from repro_torch.serve import engine
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Batcher

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _published():
    """DeepSeek-V3 at EP32's share, as the benchmark's configuration runs
    it (hf:deepseek-ai/DeepSeek-V3 config.json)."""
    cfg = get_config("deepseek-v3-671b")
    return dataclasses.replace(
        cfg, norm_eps=1e-6,
        moe=dataclasses.replace(cfg.moe, capacity_factor=32.0,
                                router="noaux_tc", n_group=8, topk_group=4,
                                routed_scaling=2.5, experts_held=8),
        mla=dataclasses.replace(cfg.mla, yarn_factor=40.0,
                                yarn_mscale_all_dim=1.0))


CFG = _published().reduced()


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, 0, device="cpu")


def test_reduced_keeps_the_gate_the_share_and_yarn():
    m, a = CFG.moe, CFG.mla
    assert (m.router, m.n_experts, m.n_group, m.topk_group) == (
        "noaux_tc", 8, 4, 2)
    assert (m.experts_held, m.routed_scaling, m.capacity_factor) == (
        4, 2.5, 8.0)
    assert (a.yarn_factor, a.yarn_mscale_all_dim) == (40.0, 1.0)
    # the registry's copy, held to JAX, keeps the softmax router
    assert get_config("deepseek-v3-671b").reduced().moe.router == "softmax"


# -- the gate --------------------------------------------------------------

def _gate(x, weight, bias, n_groups, topk_groups, topk, route_scale):
    """DeepSeek-V3 ``inference/model.py`` ``Gate.forward``, sigmoid
    scoring, in float32."""
    scores = (x @ weight).sigmoid()
    original_scores = scores
    scores = scores + bias
    scores = scores.view(x.size(0), n_groups, -1)
    group_scores = scores.topk(2, dim=-1)[0].sum(dim=-1)
    indices = group_scores.topk(topk_groups, dim=-1)[1]
    mask = scores.new_ones(x.size(0), n_groups, dtype=bool).scatter_(
        1, indices, False)
    scores = scores.masked_fill_(mask.unsqueeze(-1), float("-inf")).flatten(1)
    indices = torch.topk(scores, topk, dim=-1)[1]
    weights = original_scores.gather(1, indices)
    weights /= weights.sum(dim=-1, keepdim=True)
    return weights * route_scale, indices


def test_noaux_tc_gate_is_deepseeks(params):
    cfg = _published()             # 256 experts, 8 groups, top-8 of 4
    gen = torch.Generator().manual_seed(3)
    d = 64
    w = torch.randn(d, 256, generator=gen) * 0.3
    bias = torch.randn(256, generator=gen) * 0.05
    x = torch.randn(40, d, generator=gen)
    got_w, got_ids, scores = moe.route(
        {"router": {"w": w, "bias": bias}}, x, cfg)
    want_w, want_ids = _gate(x, w, bias, 8, 4, 8, 2.5)
    assert torch.equal(got_ids, want_ids)
    torch.testing.assert_close(got_w, want_w, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(scores, torch.sigmoid(x @ w))
    torch.testing.assert_close(got_w.sum(-1), torch.full((40,), 2.5))
    # the bias moves the choice and not the weights
    plain = moe.route({"router": {"w": w, "bias": bias * 0}}, x, cfg)[1]
    assert not torch.equal(plain, got_ids)


def test_a_group_with_the_best_expert_can_lose_on_its_best_two():
    cfg = dataclasses.replace(CFG, moe=dataclasses.replace(
        CFG.moe, experts_held=0))       # 8 experts, groups of 2, keep 2
    # logits picked so the sigmoid scores read: group 0 = (0.95, 0.05),
    # groups 1 and 2 about (0.6, 0.6), group 3 = (0.1, 0.1)
    s = torch.tensor([0.95, 0.05, 0.62, 0.61, 0.6, 0.59, 0.1, 0.1])
    w_r = torch.zeros(8, 8)
    w_r[0] = torch.log(s / (1 - s))          # x @ w_r: those logits
    x = torch.eye(8)[:1]
    bias = torch.zeros(8)
    w, ids, _ = moe.route({"router": {"w": w_r, "bias": bias}}, x, cfg)
    assert sorted(ids[0].tolist()) == [2, 3]      # never expert 0
    want_w, want_ids = _gate(x, w_r, bias, 4, 2, 2, 2.5)
    assert torch.equal(ids, want_ids)
    torch.testing.assert_close(w, want_w)
    # a bias on group 3 lifts it past groups 1 and 2
    bias = torch.tensor([0.0, 0, 0, 0, 0, 0, 0.7, 0.7])
    _, ids, _ = moe.route({"router": {"w": w_r, "bias": bias}}, x, cfg)
    assert sorted(ids[0].tolist()) == [6, 7]


# -- the share ---------------------------------------------------------------

def _layer(params, seg=1, i=0):
    return {k: ({kk: vv[i] for kk, vv in v.items()} if k == "router" else
                {kk: {"w": vv["w"][i]} for kk, vv in v.items()}
                if k == "shared" else v[i])
            for k, v in params["segments"][seg]["moe"].items()}


def test_the_shares_of_a_partition_add_up_to_the_uncut_layer():
    """Every expert's slabs, cut into shares of 4: share j relabels its
    experts 4j .. 4j + 3 as 0 .. 3 (the router's columns and the bias
    rolled by whole groups, so the group limit picks the same groups), and
    the shares' routed parts, with the shared expert counted once, sum to
    the layer that holds all 8."""
    whole = dataclasses.replace(CFG, moe=dataclasses.replace(
        CFG.moe, experts_held=0))
    layer = _layer(init_params(whole, 1, device="cpu"))
    x = torch.randn(3, 7, CFG.d_model,
                    generator=torch.Generator().manual_seed(2))
    want = moe.moe_apply(layer, x, whole)
    shared = mlp(layer["shared"], x, CFG.activation)
    held = CFG.moe.experts_held
    parts = []
    for j in range(CFG.moe.n_experts // held):
        share = dict(layer, router={
            "w": layer["router"]["w"].roll(-j * held, dims=-1),
            "bias": layer["router"]["bias"].roll(-j * held, dims=-1)})
        for name in ("wi", "wg", "wo"):
            share[name] = layer[name][j * held:(j + 1) * held]
        parts.append(moe.moe_apply(share, x, CFG) - shared)
    torch.testing.assert_close(shared + sum(parts), want, rtol=1e-5,
                               atol=1e-5)
    # each share computes a part of it, not the whole
    assert all(p.abs().max() > 1e-2 for p in parts)


def test_held_slabs_and_the_router_bias_in_the_tree(params):
    m = params["segments"][1]["moe"]
    n = CFG.segments[1].count
    assert tuple(m["wi"].shape) == (n, 4, CFG.d_model, 64)
    assert tuple(m["wo"].shape) == (n, 4, 64, CFG.d_model)
    assert tuple(m["router"]["w"].shape) == (n, CFG.d_model, 8)
    assert tuple(m["router"]["bias"].shape) == (n, 8)
    assert m["router"]["bias"].std() > 0
    bf = init_params(CFG, 0, device="cpu", dtype=torch.bfloat16)
    assert bf["segments"][1]["moe"]["router"]["bias"].dtype == torch.float32


# -- YaRN --------------------------------------------------------------------

def test_yarn_against_the_published_formulas():
    m = _published().mla                 # rope 64, factor 40, 4096
    dim, base = 64, 10_000.0

    def corr(rot):   # HF yarn_find_correction_dim
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (
            2 * math.log(base))
    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)),
                                                  dim - 1)
    assert (low, high) == (10, 23)
    extra = 1.0 / base ** (torch.arange(0, dim, 2).float() / dim)
    inter = 1.0 / (40 * base ** (torch.arange(0, dim, 2).float() / dim))
    mask = 1 - ((torch.arange(dim // 2).float() - low)
                / (high - low)).clamp(0, 1)
    want = inter * (1 - mask) + extra * mask
    got = yarn_freqs(dim, base, m)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(got[:low], extra[:low], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[high:], extra[high:] / 40, rtol=1e-6,
                               atol=0)
    pos = torch.arange(5000)
    cos, sin = mla_rope_tables(pos, m, base)
    ang = pos[:, None].float() * want
    torch.testing.assert_close(cos[:, 0], torch.cos(ang), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(sin[:, 0], torch.sin(ang), rtol=1e-4,
                               atol=1e-4)
    # softmax scale: (0.1 ln 40 + 1)^2 = 1.874
    assert yarn_mscale(40.0, 1.0) ** 2 == pytest.approx(
        (0.1 * math.log(40) + 1) ** 2)
    assert round(yarn_mscale(40.0, 1.0) ** 2, 3) == 1.874
    # factor 1 is plain RoPE, the registry's table
    plain = dataclasses.replace(m, yarn_factor=1.0)
    from repro_torch.models.layers import rope_tables
    for a, b in zip(mla_rope_tables(pos, plain, base),
                    rope_tables(pos, dim, base)):
        assert torch.equal(a, b)


def test_mla_scale_carries_mscale_squared(params):
    """The same layer with YaRN's mscale on and off: the scores differ by
    mscale^2, so a one-key call is unchanged and a two-key one not."""
    lp = {k: v[0] if not isinstance(v, dict) else
          {kk: vv[0] for kk, vv in v.items()}
          for k, v in params["segments"][0]["attn"].items()}
    x = torch.randn(1, 6, CFG.d_model,
                    generator=torch.Generator().manual_seed(5))
    pos = torch.arange(6)[None]
    off = dataclasses.replace(CFG, mla=dataclasses.replace(
        CFG.mla, yarn_mscale_all_dim=0.0))
    y_on = mla_apply(lp, x, CFG, positions=pos)[0]
    y_off = mla_apply(lp, x, off, positions=pos)[0]
    torch.testing.assert_close(y_on[:, 0], y_off[:, 0], rtol=1e-5,
                               atol=1e-6)
    assert (y_on[:, 1:] - y_off[:, 1:]).abs().max() > 1e-4


# -- the join's blockwise MLA ---------------------------------------------

def test_mla_join_in_key_blocks_equals_the_dense_core(params, monkeypatch):
    lp = {k: v[0] if not isinstance(v, dict) else
          {kk: vv[0] for kk, vv in v.items()}
          for k, v in params["segments"][0]["attn"].items()}
    gen = torch.Generator().manual_seed(7)
    n_pages, ps, b, width = 12, 4, 3, 9
    r, rope = CFG.mla.kv_lora_rank, CFG.mla.qk_rope_head_dim
    pool_k = torch.randn(n_pages + 2, ps, r, generator=gen)
    pool_v = torch.randn(n_pages + 2, ps, rope, generator=gen)
    pool_k[n_pages:] = 0
    pool_v[n_pages:] = 0
    table = torch.arange(n_pages, dtype=torch.int32).reshape(b, -1)
    depth = torch.tensor([0, 5, 2], dtype=torch.int32)
    x = torch.randn(b, width, CFG.d_model, generator=gen)
    pos = depth[:, None].long() + torch.arange(width)[None]

    def run():
        cache = PagedKVCache(pool_k.clone(), pool_v.clone(), table, depth)
        return mla_apply(lp, x, CFG, positions=pos, cache=cache)
    dense, c_dense = run()
    monkeypatch.setattr(attention, "_DENSE_LIMIT", 0)
    monkeypatch.setattr(attention, "BLOCK_Q", 4)
    monkeypatch.setattr(attention, "BLOCK_K", 5)
    blocks, c_blocks = run()
    torch.testing.assert_close(blocks, dense, rtol=1e-5, atol=1e-6)
    assert torch.equal(c_blocks.k, c_dense.k)


# -- against the plain reference -------------------------------------------

def _reference():
    path = ROOT / "portbench" / "reference" / "deepseek_v3.py"
    spec = importlib.util.spec_from_file_location("ds_v3_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_block(cfg):
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "vocab": cfg.vocab,
            "segments": [[s.kind.value, s.count] for s in cfg.segments],
            "activation": cfg.activation, "rope_theta": cfg.rope_theta,
            "norm_eps": cfg.norm_eps, "tied_embeddings": False,
            "mla": dataclasses.asdict(cfg.mla),
            "moe": dataclasses.asdict(cfg.moe)}


def test_prefill_then_paged_decode_equals_the_reference(params):
    ref = _reference()
    model = Model(CFG)
    rng = np.random.default_rng(11)
    plens, steps, ps, pages_each = [9, 4], 6, 4, 6
    prompts = torch.zeros((2, 16), dtype=torch.int32)
    for j, n in enumerate(plens):
        prompts[j, :n] = torch.from_numpy(
            rng.integers(0, CFG.vocab, n).astype(np.int32))
    caches = model.init_paged_caches(2, 2 * pages_each, ps, torch.float32,
                                     device="cpu")
    table = torch.arange(2 * pages_each, dtype=torch.int32).reshape(2, -1)
    plen_t = torch.tensor(plens, dtype=torch.int32)
    logits, caches = model.prefill_paged(params, {"tokens": prompts}, caches,
                                         table, dtype=torch.float32,
                                         last_pos=plen_t - 1)
    got = [[logits[j, -1]] for j in range(2)]
    seqs = [prompts[j, :n].tolist() for j, n in enumerate(plens)]
    length = plen_t.clone()
    for _ in range(steps):
        tok = torch.stack([g[-1].argmax() for g in got]).to(torch.int32)
        for j in range(2):
            seqs[j].append(int(tok[j]))
        logits, caches = model.decode_step(params, tok[:, None], caches,
                                           length, dtype=torch.float32,
                                           pages=table)
        length = length + 1
        for j in range(2):
            got[j].append(logits[j, -1])
    want = {i: lg for i, _, lg in ref.forward(
        params, _port_block(CFG), seqs,
        score_from=[n - 1 for n in plens])}
    for j in range(2):
        torch.testing.assert_close(torch.stack(got[j]), want[j], rtol=1e-4,
                                   atol=1e-4)


# -- serving -----------------------------------------------------------------

def _requests(n=6, seed=4):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, CFG.vocab,
                               size=int(rng.integers(5, 20))).tolist())
            for rid in range(n)]


def test_traced_batcher_counts_held_choices_on_the_device(params):
    scfg = dict(max_len=64, batch=4, dtype=torch.float32, paged=True,
                page_size=8, sync_every=3)
    served = []
    for traced in (False, True):
        b = Batcher(Model(CFG), params, ServeConfig(**scfg,
                                                    telemetry=traced))
        for rid, p in _requests():
            b.submit(rid, p)
        b.run(max_new=7)
        served.append(b)
    plain, traced = served
    assert plain.results == traced.results
    assert plain.telemetry is None or not plain.telemetry.device_counts
    hits, total = traced.telemetry.device_counts["moe.held_choice"].tolist()
    joins = [sp for sp in traced.telemetry.spans if sp["name"] == "join"]
    segs = [sp for sp in traced.telemetry.spans
            if sp["name"] == "decode-segment"]
    n_moe, k = CFG.segments[1].count, CFG.moe.top_k
    # every choice of every token the joins and the decode steps computed
    assert total == n_moe * k * (
        sum(sp["rows"] * sp["width"] for sp in joins)
        + scfg["batch"] * sum(sp["steps"] for sp in segs))
    assert 0 < hits < total
    assert traced.telemetry.summary()["moe.held_choice_share"] == \
        pytest.approx(100 * hits / total)
    assert all(sp["rows"] == sp["joined"] for sp in joins)


def test_rows_interact_only_where_experts_can_drop():
    moon = get_config("moonshot-v1-16b-a3b")
    assert engine.rows_interact(moon)                   # 6 x 1.25 < 64
    assert not engine.rows_interact(moon.reduced())     # 2 x 8 >= 8
    assert engine.rows_interact(get_config("deepseek-v3-671b"))
    assert not engine.rows_interact(_published())       # 8 x 32 = 256
    assert not engine.rows_interact(get_config("qwen2-0.5b"))
