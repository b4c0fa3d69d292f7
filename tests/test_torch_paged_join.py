"""The paged join's rows: a model whose rows do not interact (no routed
experts, or a dropless MoE) prefills only the J joining rows, a model
whose experts can drop all B slots
(:func:`repro_torch.serve.engine.make_paged_join`).  On ``reduced()``
configs in float32, on the CPU:

- the J-row join of a dense GQA model (whole prompts, a chunked piece at a
  resident depth that does not commit, a prefix-cache hit) and of the SSM
  and hybrid SSM models gives the same first tokens, slot state and
  joining rows' pages and SSM state as the B-row join (``_b_row_join``,
  the join as it was before it took the joining rows alone), to float32
  rounding with tokens equal, and leaves every other slot's pages and SSM
  state bit for bit;
- the MoE model at a capacity that drops (moonshot's 1.25) joins on B
  rows, the B-row join bit for bit, greedy and sampled;
- a dropless MoE (DeepSeek-V3's share: ``noaux_tc``, 4 of 8 experts held,
  capacity factor 8) joins on its J rows, and gives the B-row join's
  first tokens, slot state and caches bit for bit, in one call and in
  calls split by ``JOIN_CALL_TOKENS``;
- a batcher with the J-row join serves the tokens of one forced onto the
  B-row join, with chunked prefill and the prefix cache on;
- the ``join`` span's ``rows`` and the ``join.rows_computed`` counter
  read the joining rows for a dense model and B for the MoE model."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import BlockKind
from repro_torch.models.init import init_params
from repro_torch.models.model_zoo import Model
from repro_torch.serve import engine, scheduler
from repro_torch.serve.engine import (ServeConfig, make_paged_join,
                                      sample_tokens)

torch.set_num_threads(1)

ARCHS = {"dense": "qwen2-0.5b", "ssm": "mamba2-370m",
         "hybrid": "zamba2-1.2b", "moe": "moonshot-v1-16b-a3b",
         "dropless": "deepseek-v3-671b"}
B, MAX_NEW = 4, 6
SERVE = dict(max_len=64, batch=B, dtype=torch.float32, paged=True,
             page_size=8)


def _b_row_join(model, cfg, eos_id):
    """The paged join computing every slot's row: the non-joining rows
    take an all-sentinel write table, and the joining rows' state is
    selected by ``join_mask`` [B]."""
    sentinel = cfg.pool_pages
    recurrent = [seg.kind is BlockKind.SSM
                 for seg in model.cfg.resolved_segments()]

    def join(params, caches, tok, lengths, done, remaining, join_mask,
             prompts, plens, budgets, gen, pages, prefix_lens, commit_mask):
        write_tbl = torch.where(join_mask[:, None], pages,
                                torch.full_like(pages, sentinel))
        work = [{name: torch.zeros_like(t) for name, t in c.items()}
                if ssm else c for ssm, c in zip(recurrent, caches)]
        last, work = model.prefill_paged(
            params, {"tokens": prompts}, work, write_tbl, dtype=cfg.dtype,
            last_pos=plens - 1, cache_len=prefix_lens, logits=False)
        for ssm, new, old in zip(recurrent, work, caches):
            if ssm:
                for name, held in old.items():
                    mask = join_mask.reshape((1, -1) + (1,) * (held.dim()
                                                               - 2))
                    held.copy_(torch.where(mask, new[name], held))
        first = sample_tokens(model.readout(params, last)[:, -1],
                              cfg.temperature, gen)
        if eos_id is None:
            is_eos = torch.zeros_like(join_mask)
        else:
            is_eos = first == eos_id
        rem_new = budgets - 1
        new = (torch.where(commit_mask[:, None], first[:, None], tok),
               torch.where(join_mask, prefix_lens + plens, lengths),
               torch.where(commit_mask, is_eos | (rem_new <= 0),
                           join_mask | done),
               torch.where(commit_mask, rem_new,
                           torch.where(join_mask, 0, remaining)))
        for held, value in zip((tok, lengths, done, remaining), new):
            held.copy_(value)
        return caches, tok, lengths, done, remaining, first
    return join


_MODELS: dict = {}


def _config(kind):
    cfg = get_config(ARCHS[kind])
    if kind == "dropless":     # DeepSeek-V3 at EP32's share, dropless
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=32.0, router="noaux_tc", n_group=8,
            topk_group=4, routed_scaling=2.5, experts_held=8))
    cfg = cfg.reduced()
    if kind == "moe":          # top-2 x 1.25 < 8 experts: choices can drop
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
    return cfg


def _model(kind):
    if kind not in _MODELS:
        cfg = _config(kind)
        _MODELS[kind] = (Model(cfg), init_params(cfg, 0, device="cpu"))
    return _MODELS[kind]


def _state(model, scfg, seed):
    """Paged caches holding other values (live pages random, the sentinel
    page zero), random SSM state, each slot its own pages, and slot state
    that no join writes."""
    gen = torch.Generator().manual_seed(seed)
    caches = model.init_paged_caches(B, scfg.pool_pages, scfg.page_size,
                                     torch.float32, device="cpu")
    for seg, c in zip(model.cfg.resolved_segments(), caches):
        for t in c.values():
            if seg.kind is BlockKind.SSM:
                t.copy_(torch.randn(t.shape, generator=gen))
            else:
                t[:, :scfg.pool_pages].copy_(torch.randn(
                    t[:, :scfg.pool_pages].shape, generator=gen))
    table = torch.arange(scfg.pool_pages, dtype=torch.int32).reshape(B, -1)
    state = (torch.randint(0, model.cfg.vocab, (B, 1), generator=gen,
                           dtype=torch.int32),
             torch.randint(1, 40, (B,), generator=gen, dtype=torch.int32),
             torch.tensor([False, True, False, True]),
             torch.randint(1, 9, (B,), generator=gen, dtype=torch.int32))
    return caches, table, state


def _clone(caches, state):
    return ([{k: t.clone() for k, t in c.items()} for c in caches],
            tuple(t.clone() for t in state))


def _run_both(kind, rows, plens, prefix, commit, *, temperature=0.0,
              seed=0):
    """The join under test and the B-row join from one state; returns
    (before, (caches, state, first) of each, the table)."""
    model, params = _model(kind)
    scfg = ServeConfig(**SERVE, temperature=temperature)
    caches, table, state = _state(model, scfg, seed)
    rng = np.random.default_rng(seed)
    width = 16
    rows_t = torch.tensor(rows)
    prompts = torch.zeros((len(rows), width), dtype=torch.int32)
    for j, n in enumerate(plens):
        prompts[j, :n] = torch.from_numpy(
            rng.integers(0, model.cfg.vocab, n).astype(np.int32))
    plens_t = torch.tensor(plens, dtype=torch.int32)
    prefix_t = torch.tensor(prefix, dtype=torch.int32)
    commit_t = torch.tensor(commit)
    budgets = torch.tensor([MAX_NEW] * len(rows), dtype=torch.int32)
    before = _clone(caches, state)

    c_new, s_new = _clone(caches, state)
    first = make_paged_join(model, scfg, eos_id=None)(
        params, c_new, *s_new, rows_t, prompts, plens_t, budgets,
        torch.Generator().manual_seed(5), table[rows_t], prefix_t,
        commit_t)[-1]

    def spread(x, fill):
        return x.new_full((B,) + x.shape[1:], fill).index_copy(0, rows_t, x)
    c_old, s_old = _clone(caches, state)
    first_old = _b_row_join(model, scfg, None)(
        params, c_old, *s_old, spread(torch.ones(len(rows), dtype=bool),
                                      False),
        spread(prompts, 0), spread(plens_t, 1),
        spread(budgets, MAX_NEW), torch.Generator().manual_seed(5), table,
        spread(prefix_t, 0), spread(commit_t, False))[-1]
    return (model, scfg, before, (c_new, s_new, first),
            (c_old, s_old, first_old[rows_t]), table, rows_t)


def _pages_of(table, slots):
    return table[torch.as_tensor(slots)].flatten().long()


# (model, joining rows, piece lengths, resident depths, commits)
CASES = {
    "dense-whole": ("dense", [2, 0], [13, 5], [0, 0], [True, True]),
    "dense-chunk-no-commit": ("dense", [1, 3], [16, 9], [16, 0],
                              [False, True]),
    "dense-prefix-hit": ("dense", [3], [7], [24], [True]),
    "ssm-whole": ("ssm", [1], [9], [0], [True]),
    "hybrid-whole": ("hybrid", [2, 0, 3], [11, 4, 16], [0, 0, 0],
                     [True, True, True]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_joining_rows_alone_equal_the_b_row_join(case):
    kind, rows, plens, prefix, commit = CASES[case]
    model, scfg, before, new, old, table, rows_t = _run_both(
        kind, rows, plens, prefix, commit)
    assert not engine.rows_interact(model.cfg)
    (c_new, s_new, first), (c_old, s_old, first_old) = new, old
    assert torch.equal(first, first_old)
    for a, b in zip(s_new, s_old):        # tok, lengths, done, remaining
        assert torch.equal(a, b)
    others = [s for s in range(B) if s not in rows]
    joined_pages = _pages_of(table, rows)
    other_pages = _pages_of(table, others)
    for seg, cn, co, cb in zip(model.cfg.resolved_segments(), c_new, c_old,
                               before[0]):
        for name in cn:
            n, o, b = cn[name], co[name], cb[name]
            if seg.kind is BlockKind.SSM:    # [layers, B, ...] per slot
                np.testing.assert_allclose(n[:, rows_t].numpy(),
                                           o[:, rows_t].numpy(),
                                           rtol=1e-5, atol=1e-5)
                assert torch.equal(n[:, others], b[:, others])
            else:                            # pools: the sink page aside
                np.testing.assert_allclose(n[:, joined_pages].numpy(),
                                           o[:, joined_pages].numpy(),
                                           rtol=1e-5, atol=1e-5)
                assert torch.equal(n[:, other_pages], b[:, other_pages])
                assert torch.equal(n[:, scfg.pool_pages],
                                   b[:, scfg.pool_pages])


@pytest.mark.parametrize("temperature", [0.0, 0.7],
                         ids=["greedy", "sampled"])
def test_moe_join_is_the_b_row_join_bit_for_bit(temperature):
    model, _, _, new, old, _, _ = _run_both(
        "moe", [3, 1], [12, 6], [0, 0], [True, True],
        temperature=temperature)
    assert engine.rows_interact(model.cfg)
    (c_new, s_new, first), (c_old, s_old, first_old) = new, old
    assert torch.equal(first, first_old)
    for a, b in zip(s_new, s_old):
        assert torch.equal(a, b)
    for cn, co in zip(c_new, c_old):
        for name in cn:
            assert torch.equal(cn[name], co[name]), name


@pytest.mark.parametrize("call_tokens", [8192, 16],
                         ids=["one-call", "row-calls"])
def test_dropless_moe_joins_its_rows_alone_bit_for_bit(call_tokens,
                                                        monkeypatch):
    monkeypatch.setattr(engine, "JOIN_CALL_TOKENS", call_tokens)
    model, scfg, before, new, old, _, _ = _run_both(
        "dropless", [3, 0, 1], [12, 16, 6], [0, 0, 0], [True, True, True])
    assert not engine.rows_interact(model.cfg)
    assert model.cfg.moe.experts_held < model.cfg.moe.n_experts
    (c_new, s_new, first), (c_old, s_old, first_old) = new, old
    assert torch.equal(first, first_old)
    for a, b in zip(s_new, s_old):
        assert torch.equal(a, b)
    live = slice(0, scfg.pool_pages + 1)     # every page but the sink
    for cn, co, cb in zip(c_new, c_old, before[0]):
        for name in cn:
            assert torch.equal(cn[name][:, live], co[name][:, live]), name
            assert not torch.equal(cn[name][:, live], cb[name][:, live])


def _requests(vocab, n=7, seed=4, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, size=shared).tolist()
    return [(rid, head + rng.integers(0, vocab, size=int(
        rng.integers(4, 20))).tolist()) for rid in range(n)]


FEATURES = {"plain": {}, "chunked-prefix-cache": dict(
    prefill_chunk=8, prefix_cache=True)}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_batcher_serves_the_b_row_joins_tokens(feature, monkeypatch):
    """The dense model served with its J-row joins, and with its joins
    forced onto all B rows: the same tokens."""
    model, params = _model("dense")
    shared = 16 if FEATURES[feature] else 0
    got = []
    for forced in (False, True):
        if forced:
            for mod in (engine, scheduler):
                monkeypatch.setattr(mod, "rows_interact", lambda cfg: True)
        b = scheduler.Batcher(model, params, ServeConfig(**SERVE, sync_every=3,
                                               **FEATURES[feature]))
        for rid, p in _requests(model.cfg.vocab, shared=shared):
            b.submit(rid, p)
        b.run(max_new=MAX_NEW)
        got.append((b.results, b.metrics.value("join.rows_computed"),
                    b.joins))
    (res, rows, joins), (res_b, rows_b, joins_b) = got
    assert res == res_b and len(res) == 7
    assert joins == joins_b and rows_b == B * joins_b
    assert rows < rows_b
    if shared:
        assert b.metrics.value("join.chunk_continuations") > 0
        assert b.prefix_stats()["prefill_skipped"] > 0


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_join_span_and_counter_count_the_rows_computed(kind):
    model, params = _model(kind)
    b = scheduler.Batcher(model, params, ServeConfig(**SERVE, sync_every=3,
                                           telemetry=True))
    for rid, p in _requests(model.cfg.vocab):
        b.submit(rid, p)
    b.run(max_new=MAX_NEW)
    joins = [sp for sp in b.telemetry.spans if sp["name"] == "join"]
    assert len(joins) == b.joins >= 2
    want = [B if kind == "moe" else sp["joined"] for sp in joins]
    assert [sp["rows"] for sp in joins] == want
    assert b.metrics.value("join.rows_computed") == sum(want)
    if kind == "dense":
        assert any(sp["joined"] < B for sp in joins)
    assert b.telemetry.summary()["join.useful_token_share"] == \
        pytest.approx(100 * sum(sp["real_tokens"] for sp in joins)
                      / sum(r * sp["width"] for r, sp in zip(want, joins)))
