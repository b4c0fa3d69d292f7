"""The port's paged-attention autotuner against ``tests/test_autotune.py``
in the port's terms: feasibility refusals with their reasons, the pruner
(default first, the budget cut, duplicate launches), winner selection and
persistence per op on a CPU workload, the cache's merge, memo and
environment override, the policy's hit, miss and corrupt-file fallback,
and its field-by-field handling of malformed entries held to JAX's
``DecodeAttnPolicy.tuned_config`` on the same files.  Also exact parity
with JAX of the seeded workloads, ``_page_fetches`` and
``candidate_traffic``, and ``split_count`` with the default knobs against
the rule the kernels ran before the knobs existed.  CPU only: the card
sweep is ``chip_smoke.py``'s ``[autotune]`` phase."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attn_policy as jax_policy
from repro.kernels.paged_attn import autotune as jat
from repro_torch.core.hwspec import DEFAULT_HOPPER
from repro_torch.kernels.decode_attn import (DecodeAttnPolicy,
                                             decode_attn_policy)
from repro_torch.kernels.paged_attn import autotune as at
from repro_torch.kernels.paged_attn import split

torch.set_num_threads(1)

GEOM = at.Geometry(hq=4, hkv=2, d=8, page_size=8)   # g=2, tiny but GQA
JGEOM = jat.Geometry(hq=4, hkv=2, d=8, page_size=8)
QWEN = at.Geometry(hq=14, hkv=2, d=64, page_size=16)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv(at.ENV_VAR, raising=False)
    monkeypatch.delenv(jat.ENV_VAR, raising=False)


# --------------------------------------------------------------------------
# feasibility and the pruner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op,cand,why", [
    ("prefill", at.Candidate(block_rows=24), "16-row"),
    ("verify", at.Candidate(block_rows=8), "16-row"),
    ("prefill", at.Candidate(block_rows=128), "64-key tile buffer"),
    ("prefill", at.Candidate(block_rows=48), "not instantiated"),
    ("decode", at.Candidate(block_rows=32), "no query-row block"),
    ("verify", at.Candidate(cta_rows=4), "no split-KV walk"),
    ("decode", at.Candidate(cta_rows=3), "not instantiated"),
    ("decode", at.Candidate(ctas_per_sm=0), ">= 1")])
def test_feasible_refuses_with_its_reason(op, cand, why):
    ok, reason = at.feasible(cand, op=op, lg=40, geom=QWEN)
    assert not ok and why in reason


def test_feasible_refuses_shared_memory_and_cluster_overflow():
    tiny = dataclasses.replace(DEFAULT_HOPPER, smem_per_cta=1024)
    for op in at.OPS:
        ok, why = at.feasible(at.Candidate(), op=op, lg=35, geom=QWEN,
                              spec=tiny)
        assert not ok and "shared memory" in why
        # the same launch fits the card's 227 KiB
        assert at.feasible(at.Candidate(), op=op, lg=35, geom=QWEN)[0]
    # one slot wants 8 ranks a cluster: above a cluster limit of 4
    four = dataclasses.replace(DEFAULT_HOPPER, max_cluster=4)
    ok, why = at.feasible(at.Candidate(), op="decode", lg=7, geom=QWEN,
                          spec=four, batch=1, key_bound=1024)
    assert not ok and "portable cluster of 4" in why
    assert at.feasible(at.Candidate(), op="decode", lg=7, geom=QWEN,
                       batch=1, key_bound=1024)[0]


def test_feasible_refuses_more_ranks_than_tiles(monkeypatch):
    monkeypatch.setattr(split, "split_count", lambda *a, **k: 8)
    ok, why = at.feasible(at.Candidate(), op="decode", lg=7, geom=QWEN,
                          batch=8, key_bound=32)
    assert not ok and "2 tiles" in why


def test_prune_keeps_default_first_and_drops_refused():
    wl = at.make_workload("prefill", GEOM)       # lq=8, g=2 -> lg=16
    bad = at.Candidate(block_rows=24)
    survivors, pruned = at.prune(wl, [at.Candidate(block_rows=16),
                                      at.Candidate(), bad])
    assert survivors[0] == at.Candidate()
    assert bad not in survivors
    assert any(c == bad and "16-row" in why for c, why in pruned)


def test_prune_budget_cut_retains_default():
    wl = at.make_workload("decode", QWEN, b=8, lq=1, pages=None,
                          depths=(64, 600))
    survivors, pruned = at.prune(wl, budget=2)
    assert len(survivors) == 2 and survivors[0] == at.Candidate()
    assert any("budget" in why for _, why in pruned)


def test_prune_drops_duplicate_launches():
    """At moonshot's G 1 every ``cta_rows`` keeps one row: one launch
    shape per split count, the default's kept."""
    geom = at.Geometry(hq=16, hkv=16, d=128, page_size=16)
    wl = at.make_workload("decode", geom, b=8, lq=1, pages=None,
                          depths=(64, 600))
    survivors, pruned = at.prune(wl)
    shapes = [at.launch_shape(wl, c) for c in survivors]
    assert len(set(shapes)) == len(shapes) and survivors[0] == at.Candidate()
    assert {at.launch_shape(wl, c) for c, _ in pruned} <= set(shapes)
    assert all("launches what" in why for _, why in pruned)


def test_enumerate_puts_the_default_first():
    for op in at.OPS:
        cands = at.enumerate_candidates(op, 35)
        assert cands[0] == at.Candidate()
        assert len(set(cands)) == len(cands)
    assert len(at.enumerate_candidates("decode")) == 12
    assert len(at.enumerate_candidates("verify", 35)) == 3


# --------------------------------------------------------------------------
# end-to-end sweep + cache roundtrip (CPU: the plain route)
# --------------------------------------------------------------------------

def test_autotune_selects_and_persists_winner_per_op(tmp_path):
    res = at.autotune(geom=GEOM, budget=2, reps=1)
    assert set(res) == set(at.OPS)
    for op, r in res.items():
        assert isinstance(r["winner"], dict)
        # the default is always measured, so the argmin never loses to it
        assert r["winner_ms"] <= r["default_ms"]
        assert r["candidates"][0]["config"] == at.Candidate().as_dict(op)
        assert all(row["bit_exact"] for row in r["candidates"])
        assert r["card"] == "cpu"
    path = at.save_entries(res, str(tmp_path / "tuned.json"))
    entries = at.load_entries(path)
    for op in at.OPS:
        ent = entries[at.entry_key("cpu", op, GEOM)]
        assert ent["config"] == res[op]["winner"]
        assert ent["default_ms"] == round(res[op]["default_ms"], 6)


def test_save_entries_merges_and_discards_unknown_schema(tmp_path):
    p = tmp_path / "tuned.json"
    keep = {"schema": at.SCHEMA,
            "entries": {"cuda|decode|other": {"config": {"cta_rows": 4}}}}
    p.write_text(json.dumps(keep))
    res = at.autotune(ops=("decode",), geom=GEOM, reps=1)
    at.save_entries(res, str(p))
    entries = at.load_entries(str(p))
    assert "cuda|decode|other" in entries          # merged, not clobbered
    assert at.entry_key("cpu", "decode", GEOM) in entries
    # an unknown on-disk schema is discarded rather than half-merged
    p.write_text(json.dumps({"schema": 99, "entries": keep["entries"]}))
    at.save_entries(res, str(p))
    assert "cuda|decode|other" not in at.load_entries(str(p))


# --------------------------------------------------------------------------
# policy-side loading
# --------------------------------------------------------------------------

def _cache_file(tmp_path, config, op="decode", geom=GEOM, backend="cpu",
                name="cache.json"):
    p = tmp_path / name
    p.write_text(json.dumps({"schema": at.SCHEMA, "entries": {
        at.entry_key(backend, op, geom): {"config": config}}}))
    return str(p)


def test_policy_cache_hit_and_miss(tmp_path):
    path = _cache_file(tmp_path, {"ctas_per_sm": 4, "cta_rows": 1})
    with decode_attn_policy(use_tuned=True, tuned_path=path) as pol:
        assert pol.tuned_config("decode", hq=4, hkv=2, d=8, page_size=8,
                                backend="cpu") == {"ctas_per_sm": 4,
                                                   "cta_rows": 1}
        # another geometry, op or device type misses
        assert pol.tuned_config("decode", hq=8, hkv=8, d=64, page_size=16,
                                backend="cpu") is None
        assert pol.tuned_config("prefill", hq=4, hkv=2, d=8, page_size=8,
                                lg=16, backend="cpu") is None
        assert pol.tuned_config("decode", hq=4, hkv=2, d=8,
                                page_size=8) is None          # cuda key
    with decode_attn_policy(use_tuned=False, tuned_path=path) as pol:
        assert pol.tuned_config("decode", hq=4, hkv=2, d=8, page_size=8,
                                backend="cpu") is None


def test_policy_corrupt_cache_degrades_to_defaults(tmp_path):
    p = tmp_path / "corrupt.json"
    p.write_text("{not json")
    with decode_attn_policy(use_tuned=True, tuned_path=str(p)) as pol:
        assert pol.tuned_config("decode", hq=4, hkv=2, d=8, page_size=8,
                                backend="cpu") is None


def test_policy_sanitizes_block_rows_and_cta_rows_field_by_field(tmp_path):
    path = _cache_file(tmp_path, {"block_rows": 16, "cta_rows": 3},
                       op="prefill")
    with decode_attn_policy(use_tuned=True, tuned_path=path) as pol:
        # a ragged last block is fine here, unlike JAX: lg 12 keeps 16
        for lg in (12, 16, 35, None):
            assert pol.tuned_config("prefill", hq=4, hkv=2, d=8,
                                    page_size=8, lg=lg,
                                    backend="cpu") == {"block_rows": 16}
    path = _cache_file(tmp_path, {"block_rows": 20, "cta_rows": 4,
                                  "ctas_per_sm": 3}, name="b.json")
    with decode_attn_policy(use_tuned=True, tuned_path=path) as pol:
        assert pol.tuned_config("decode", hq=4, hkv=2, d=8, page_size=8,
                                backend="cpu") == {"cta_rows": 4}


def test_policy_object_keeps_the_entries_it_loaded(tmp_path):
    """A batcher's policy is built once: a rewrite of the file afterwards
    does not reach it, while a new policy sees the rewrite."""
    path = _cache_file(tmp_path, {"cta_rows": 4})
    pol = DecodeAttnPolicy(tuned_path=path)
    with open(path, "w") as f:
        json.dump({"schema": at.SCHEMA, "entries": {}}, f)
    with decode_attn_policy(pol) as active:
        assert active is pol
        assert active.tuned_config("decode", hq=4, hkv=2, d=8, page_size=8,
                                   backend="cpu") == {"cta_rows": 4}
    assert DecodeAttnPolicy(tuned_path=path).tuned_config(
        "decode", hq=4, hkv=2, d=8, page_size=8, backend="cpu") is None
    with pytest.raises(TypeError):
        with decode_attn_policy(pol, mode="plain"):
            pass
    with pytest.raises(ValueError):
        DecodeAttnPolicy(mode="xla")


def test_env_var_disables_and_redirects(tmp_path, monkeypatch):
    path = _cache_file(tmp_path, {"cta_rows": 4})
    for off in ("", "off", "0", "ignore", "none"):
        monkeypatch.setenv(at.ENV_VAR, off)
        assert at.load_entries(path) == {}       # env wins over the path
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"schema": at.SCHEMA,
                                 "entries": {"x|y|z": {"config": {}}}}))
    monkeypatch.setenv(at.ENV_VAR, str(other))
    assert "x|y|z" in at.load_entries(path)


def test_load_memo_invalidates_on_rewrite(tmp_path):
    path = _cache_file(tmp_path, {"cta_rows": 4})
    first = at.load_entries(path)
    assert first and at.load_entries(path) is first      # memo hit
    with open(path, "w") as f:
        json.dump({"schema": at.SCHEMA, "entries": {}}, f)
    assert at.load_entries(path) == {}                   # mtime/size key


# Malformed entries: the same shape of damage in a JAX file (its knobs
# grid_order and block_rows) and a port file (cta_rows or ctas_per_sm for
# JAX's enum-valued grid_order; block_rows for block_rows).  The lookups
# use lg 48, which every valid block_rows of either package divides.
_ENUM_J, _ENUM_P = "grid_order", "cta_rows"
MALFORMED = [
    ("non-dict entry", [], []),
    ("entry without config", {"cfg": {}}, {"cfg": {}}),
    ("null config", {"config": None}, {"config": None}),
    ("empty config", {"config": {}}, {"config": {}}),
    ("string rows", {"config": {"block_rows": "16"}},
     {"config": {"block_rows": "16"}}),
    ("negative rows", {"config": {"block_rows": -16}},
     {"config": {"block_rows": -16}}),
    ("zero rows", {"config": {"block_rows": 0}},
     {"config": {"block_rows": 0}}),
    ("float rows", {"config": {"block_rows": 16.0}},
     {"config": {"block_rows": 16.0}}),
    ("good rows", {"config": {"block_rows": 16}},
     {"config": {"block_rows": 16}}),
    ("bad enum, good rows", {"config": {_ENUM_J: "zz", "block_rows": 16}},
     {"config": {_ENUM_P: 3, "block_rows": 16}}),
    ("good enum, bad rows", {"config": {_ENUM_J: "hb", "block_rows": 7}},
     {"config": {_ENUM_P: 4, "block_rows": 7}}),
    ("bad enum alone", {"config": {_ENUM_J: 5}}, {"config": {_ENUM_P: "5"}}),
    ("good enum alone", {"config": {_ENUM_J: "hb"}},
     {"config": {"ctas_per_sm": 8}}),
]


def _kinds(cfg):
    """The fields a lookup kept, by role: 'rows' or 'enum'."""
    if cfg is None:
        return None
    return {"rows" if k == "block_rows" else "enum" for k in cfg}


@pytest.mark.parametrize("op", ["decode", "prefill"])
@pytest.mark.parametrize("label,jent,pent", MALFORMED,
                         ids=[m[0] for m in MALFORMED])
def test_malformed_entries_handled_as_jax_handles_them(tmp_path, op, label,
                                                       jent, pent):
    jpath = tmp_path / "jax.json"
    jpath.write_text(json.dumps({"schema": jat.SCHEMA, "entries": {
        jat.entry_key(jax.default_backend(), op, JGEOM): jent}}))
    ppath = tmp_path / "port.json"
    ppath.write_text(json.dumps({"schema": at.SCHEMA, "entries": {
        at.entry_key("cpu", op, GEOM): pent}}))
    with jax_policy(use_tuned=True, tuned_path=str(jpath)) as jpol:
        want = jpol.tuned_config(op, hq=4, hkv=2, d=8, page_size=8, lg=48)
    with decode_attn_policy(use_tuned=True, tuned_path=str(ppath)) as pol:
        got = pol.tuned_config(op, hq=4, hkv=2, d=8, page_size=8, lg=48,
                               backend="cpu")
    assert _kinds(got) == _kinds(want), (label, got, want)


def test_block_rows_need_not_divide_the_rows_unlike_jax(tmp_path):
    """The one check that differs: JAX drops a block_rows that does not
    divide Lq x G (its row blocks must tile the rows); the port's last
    row block may be ragged, so it keeps it."""
    jpath = _cache_file(tmp_path, {"block_rows": 16}, op="prefill",
                        name="jax.json")
    with jax_policy(use_tuned=True, tuned_path=jpath) as jpol:
        assert jpol.tuned_config("prefill", hq=4, hkv=2, d=8, page_size=8,
                                 lg=40) is None
    with decode_attn_policy(use_tuned=True, tuned_path=jpath) as pol:
        assert pol.tuned_config("prefill", hq=4, hkv=2, d=8, page_size=8,
                                lg=40, backend="cpu") == {"block_rows": 16}


# --------------------------------------------------------------------------
# exact parity with JAX: workloads, page fetches, candidate traffic
# --------------------------------------------------------------------------

def _both(op, seed, **kw):
    wl = at.make_workload(op, GEOM, seed=seed, **kw)
    jwl = jat.make_workload(op, JGEOM, seed=seed, **kw)
    return wl, jwl


@pytest.mark.parametrize("op", at.OPS)
@pytest.mark.parametrize("seed", [0, 3])
def test_workloads_equal_jax(op, seed):
    wl, jwl = _both(op, seed, b=2, lq=8, pages=16)
    for name in ("q", "k_pages", "v_pages", "table", "lengths"):
        np.testing.assert_array_equal(getattr(wl, name).numpy(),
                                      np.asarray(getattr(jwl, name)))
    if op != "decode":
        np.testing.assert_array_equal(wl.q_offset.numpy(),
                                      np.asarray(jwl.q_offset))
    assert wl.lg == jwl.lg


@pytest.mark.parametrize("op", at.OPS)
@pytest.mark.parametrize("seed,b,lq,pages", [(0, 2, 8, 16), (1, 4, 6, 32),
                                              (2, 2, 12, 24)])
def test_page_fetches_and_candidate_traffic_equal_jax(op, seed, b, lq,
                                                      pages):
    wl, jwl = _both(op, seed, b=b, lq=lq, pages=pages)
    rows = [None] if op == "decode" else \
        [None] + [r for r in range(1, wl.lg + 1) if wl.lg % r == 0]
    for br in rows:
        assert at._page_fetches(wl, br) == jat._page_fetches(jwl, br)
        if br is None:
            continue
        got = at.candidate_traffic(wl, at.Candidate(block_rows=br))
        want = jat.candidate_traffic(jwl, jat.Candidate("bh", br))
        assert got == want, (br, got, want)
    if op == "decode":
        assert at.candidate_traffic(wl, at.Candidate()) == \
            jat.candidate_traffic(jwl, jat.Candidate())


def test_ragged_row_blocks_rewalk_up_to_their_own_top():
    """A block_rows that does not divide the rows: the last, ragged block
    walks to the last row's causal top, as the kernels do."""
    wl = at.make_workload("verify", QWEN, b=8, lq=5, pages=None,
                          depths=(320, 600))            # lg 35
    ps, p_max = 16, int(wl.table.shape[1])
    off, ln = wl.q_offset.numpy(), wl.lengths.numpy()
    want = 0
    for first in range(0, 35, 16):
        top = off + (min(first + 16, 35) - 1) // 7
        end = np.clip(np.minimum(ln, top + 1), 0, p_max * ps)
        want += int(np.sum((end + ps - 1) // ps))
    assert at._page_fetches(wl, 16) == want
    assert at._page_fetches(wl, 64) == at._page_fetches(wl, None)


# --------------------------------------------------------------------------
# the default knobs are the old launches
# --------------------------------------------------------------------------

def _old_split_count(batch, hkv, group, key_bound, sms):
    """``split.split_count`` as the kernels ran it before the launch knobs
    (two CTAs an SM, two query rows a CTA)."""
    tiles = -(-max(int(key_bound), 0) // 16)
    ctas = batch * hkv * -(-max(int(group), 1) // 2)
    s = 1
    while s < 8 and ctas * s < 2 * sms and 2 * s <= tiles:
        s *= 2
    return s


def test_split_count_defaults_equal_the_old_rule():
    bounds = sorted({0, 4096} | {t * 16 + e for t in range(1, 257, 5)
                                 for e in (-1, 0, 1)})
    for batch in range(1, 65):
        for hkv in (1, 2, 16):
            for group in (1, 4, 7, 16):
                for bound in bounds:
                    assert split.split_count(batch, hkv, group, bound,
                                             132) == \
                        _old_split_count(batch, hkv, group, bound, 132)


def test_the_committed_cache_holds_every_swept_key():
    """The committed winners (swept on the card) load through a default
    policy, for the three ops at qwen2-0.5b's and moonshot's geometries,
    each with its provenance: the card's name and power limit and both
    device times, the winner no slower than the default."""
    pol = DecodeAttnPolicy()
    entries = at.load_entries()
    for hq, hkv, d in ((14, 2, 64), (16, 16, 128)):
        geom = at.Geometry(hq, hkv, d, 16)
        for op in at.OPS:
            ent = entries[at.entry_key("cuda", op, geom)]
            assert ent["card"].startswith("NVIDIA H100")
            assert ent["card"].endswith(" W")
            assert 0 < ent["ms"] <= ent["default_ms"]
            assert pol.tuned_config(op, hq=hq, hkv=hkv, d=d,
                                    page_size=16) == ent["config"]
