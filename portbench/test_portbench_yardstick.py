"""The benchmark's yardstick and discovery, on the CPU: the operation and
byte counts against hand-worked cases, the traffic generator, the
capacity argument and every name in BENCHMARK.json resolving to files."""
import dataclasses
import json
import math

import numpy as np
import pytest

from portbench import check, flops, spec, traffic

TINY = flops.Shapes(d=8, hq=4, hkv=2, hd=2, d_ff=16, vocab=10, gated=False,
                    layers=("dense", "moe"), n_experts=4, top_k=2,
                    d_ff_expert=3, d_ff_shared=5)


def test_active_params_by_hand():
    attn = 8 * 2 * (2 * 4 + 2 * 2)                  # q, k, v, o = 192
    dense = 2 * 8 * 16                              # plain MLP = 256
    moe = 8 * 4 + 2 * 3 * 8 * 3 + 3 * 8 * 5         # router, 2 experts, shared
    assert TINY.active_params() == 2 * attn + dense + moe


def test_prompt_and_decode_flops_by_hand():
    n = TINY.active_params()
    # a 3-token prompt: 2 n a token, keys 1 + 2 + 3 = 6 over 2 layers of
    # 4 heads of 2, one read-out of 8 x 10
    assert flops.prompt_flops(TINY, 3) == 2 * n * 3 + 4 * 4 * 2 * 6 * 2 \
        + 2 * 8 * 10
    assert flops.decode_flops(TINY, 5) == 2 * n + 4 * 4 * 2 * 5 * 2 \
        + 2 * 8 * 10


def test_paged_decode_work_by_hand():
    f, b = flops.paged_decode_work(TINY, [3, 5])
    assert f == 4 * 4 * 2 * 8 * 2
    # 8 keys x 2 heads x 2 dims x (k, v) x 2 bytes, q and out of 2 rows
    assert b == (8 * 2 * 2 * 2 * 2 + 2 * 2 * 4 * 2 * 2) * 2


def test_paged_prefill_work_by_hand():
    f, b = flops.paged_prefill_work(TINY, [2, 3])
    assert f == 4 * 4 * 2 * (3 + 6) * 2
    assert b == 5 * (2 * 4 + 2 * 2) * 2 * 2 * 2


def test_group_gemm_work_by_hand():
    f, b = flops.group_gemm_work(TINY, 1)
    # one row: 2 of 4 experts, 2 x (1 - (1 - 1/2)) ... = 2 touched
    assert flops.experts_touched(TINY, 1) == pytest.approx(2.0)
    assert f == 2 * 2 * 3 * 8 * 3
    assert b == pytest.approx((2 * 3 * 8 * 3 + 2 * 2 * 8) * 2)
    # many rows touch every expert
    assert flops.experts_touched(TINY, 64) == pytest.approx(4.0)
    assert flops.group_gemm_work(flops.Shapes(
        d=8, hq=4, hkv=2, hd=2, d_ff=16, vocab=10, gated=False,
        layers=("dense",)), 5) == (0.0, 0.0)


# DeepSeek-V3's published widths (hf:deepseek-ai/DeepSeek-V3 config.json)
DEEPSEEK = flops.Shapes(
    d=7168, hq=128, hkv=128, hd=56, d_ff=18432, vocab=129280, gated=True,
    layers=("dense", "moe"), n_experts=256, top_k=8, d_ff_expert=2048,
    d_ff_shared=2048, attn="mla", q_lora=1536, kv_lora=512, nope=128,
    rope=64, v_dim=128)


def test_mla_counts_by_hand_at_deepseek_v3_widths():
    s = DEEPSEEK
    # q_a, q_b, kv_a, kv_b (once a token), o
    assert s.attn_params() == (7168 * 1536 + 1536 * 128 * (128 + 64)
                               + 7168 * (512 + 64) + 512 * 128 * (128 + 128)
                               + 128 * 128 * 7168) == 187_105_280
    assert s.layer_params("dense") == 187_105_280 + 3 * 7168 * 18432 \
        == 583_467_008
    # the router over 256, 8 routed experts and the shared one
    assert s.layer_params("moe") == 187_105_280 + 7168 * 256 \
        + 8 * 3 * 7168 * 2048 + 3 * 7168 * 2048 == 585_302_016
    # decode, absorbed: scores over the 576-wide key, values over the
    # 512-wide latent
    assert s.attn_flops_per_key() == 2 * 128 * (512 + 64 + 512) == 278_528
    assert flops.attention_flops(s, 10) == 278_528 * 10 * 2
    # prefill, each key expanded once: scores over nope + rope, values
    # over v, a head
    assert s.attn_flops_per_key(prefill=True) == 2 * 128 * (128 + 64) \
        + 2 * 128 * 128 == 81_920
    assert s.active_params() == 583_467_008 + 585_302_016
    # without q_lora the query is projected from d
    assert dataclasses.replace(s, q_lora=0).attn_params() == \
        187_105_280 - 7168 * 1536 - 1536 * 128 * 192 + 7168 * 128 * 192


def test_mla_prompt_and_decode_flops_by_hand():
    s = DEEPSEEK
    n = 583_467_008 + 585_302_016
    read = 2 * 7168 * 129280
    # a 4,096-token prompt: 2 n a token, and 4096 x 4097 / 2 causal keys
    # at 81,920 a key in each of the two layers
    assert flops.prompt_flops(s, 4096) == 2 * n * 4096 \
        + 81_920 * (4096 * 4097 // 2) * 2 + read
    # a decoded token over 4,096 keys at 278,528 a key a layer
    assert flops.decode_flops(s, 4096) == 2 * n + 278_528 * 4096 * 2 + read
    # GQA counts one form for both
    assert TINY.attn_flops_per_key(prefill=True) == \
        TINY.attn_flops_per_key() == 4 * 4 * 2


def test_mla_config_reads_through_shapes_of():
    port = {"d_model": 7168, "n_heads": 128, "kv_heads": 128,
            "head_dim": None, "d_ff": 18432, "vocab": 129280,
            "gated_mlp": True, "segments": [["dense", 3], ["moe", 58]],
            "attn": "mla",
            "mla": {"q_lora_rank": 1536, "kv_lora_rank": 512,
                    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                    "v_head_dim": 128},
            "moe": {"n_experts": 256, "top_k": 8, "d_ff_expert": 2048,
                    "n_shared_experts": 1, "d_ff_shared": 2048,
                    "capacity_factor": 1.25}}
    s = flops.Shapes.of(port)
    assert dataclasses.replace(s, layers=DEEPSEEK.layers) == DEEPSEEK
    assert s.active_params() == 3 * 583_467_008 + 58 * 585_302_016
    with pytest.raises(NotImplementedError, match="ssm"):
        flops.Shapes.of(dict(port, segments=[["ssm", 2]]))


# the parent's counts (the benchmark as first accepted), as literals
PARENT_COUNTS = {
    "moonshot-v1-16b-a3b": {
        "prompt_flops": {1000: 4761283952640.0, 3584: 18086906298368.0},
        "decode_flops": {1500: 5652774912.0},
        "group_gemm_work": {1: (2699034624.0, 2700312576.0),
                            64: (172738215936.0, 28818633619.795086),
                            4096: (11055245819904.0, 34024194048.0)},
        "paged_decode_work": (348807168.0, 349470720.0),
        "paged_prefill_work": (1537034158080.0, 2038431744.0)},
    "starcoder2-3b": {
        "prompt_flops": {1000: 5941488549888.0, 3584: 23000512462848.0},
        "decode_flops": {1500: 6611632128.0},
        "group_gemm_work": {1: (0.0, 0.0), 64: (0.0, 0.0),
                            4096: (0.0, 0.0)},
        "paged_decode_work": (581345280.0, 49551360.0),
        "paged_prefill_work": (2561723596800.0, 1840250880.0)},
}


@pytest.mark.parametrize("name", sorted(PARENT_COUNTS))
def test_counts_of_the_accepted_configs_are_unchanged(name):
    want = PARENT_COUNTS[name]
    s = flops.Shapes.of(json.loads((spec.HERE / "configs" /
                                    f"{name}.json").read_text())["port"])
    for n, v in want["prompt_flops"].items():
        assert flops.prompt_flops(s, n) == v
    for n, v in want["decode_flops"].items():
        assert flops.decode_flops(s, n) == v
    for n, v in want["group_gemm_work"].items():
        assert flops.group_gemm_work(s, n) == v
    assert flops.paged_decode_work(s, [300, 1200, 77]) == \
        want["paged_decode_work"]
    assert flops.paged_prefill_work(s, [1024, 3584]) == \
        want["paged_prefill_work"]


def test_bound_and_share():
    assert flops.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert flops.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert flops.share(0.5, 1.0) == pytest.approx(50.0)
    assert flops.share(0.5, 0.0) is None


def test_moonshot_shapes_match_the_published_model():
    cfg = json.loads((spec.HERE / "configs" /
                      "moonshot-v1-16b-a3b.json").read_text())
    s = flops.Shapes.of(cfg["port"])
    assert (s.d, s.n_experts, s.top_k, s.d_ff_expert) == (
        cfg["hidden_size"], cfg["n_routed_experts"],
        cfg["num_experts_per_tok"], cfg["moe_intermediate_size"])
    assert len(s.layers) == cfg["num_hidden_layers"]
    assert s.layers[:cfg["first_k_dense_replace"]] == ("dense",)
    # about 3 B parameters a token (Moonlight's "A3B"), read-out excluded
    assert 2.0e9 < s.active_params() < 3.2e9


@pytest.mark.parametrize("name", ["decode_backlog", "completion_open"])
def test_traffic_is_the_same_work_for_every_seed(name):
    mix = traffic.Mix.load(spec.traffic_path(name))

    def block(seed):
        st = traffic.Stream(mix, seed, 1000)
        return [st.next() for _ in range(mix.block)]
    a, a2, b = block(2**31 + 11), block(2**31 + 11), block(7)
    assert [r.prompt for r in a] == [r.prompt for r in a2]
    assert [r.out_len for r in a] == [r.out_len for r in a2]
    assert [r.prompt for r in a] != [r.prompt for r in b]
    for key in (lambda r: len(r.prompt), lambda r: r.out_len):
        assert sorted(map(key, a)) == sorted(map(key, b))
    sizes_a = [(len(r.prompt), r.out_len) for r in a]
    sizes_b = [(len(r.prompt), r.out_len) for r in b]
    assert (sizes_a == sizes_b) == (mix.order == "fixed")
    lo, hi = mix.prompt_tokens["lo"], mix.prompt_tokens["hi"]
    assert all(lo <= len(r.prompt) <= hi for r in a + b)
    assert all(1 <= r.out_len <= mix.output_tokens["hi"] for r in a + b)
    assert all(0 <= t < 1000 for r in a for t in r.prompt)
    if mix.kind == "open":
        gaps = np.diff([0.0] + [r.arrival for r in a])
        assert np.all(gaps > 0)
        assert np.mean(gaps) == pytest.approx(1 / mix.rate_per_s, rel=0.02)
        assert sorted(np.diff([0.0] + [r.arrival for r in b])) == \
            pytest.approx(sorted(gaps))


def test_backlog_first_fill_is_staggered():
    """The first fill owes shares of its draws, the same multiset for
    every seed; later requests owe whole draws."""
    mix = traffic.Mix.load(spec.traffic_path("decode_backlog"))

    def fill(seed):
        st = traffic.Stream(mix, seed, 100)
        first = [st.next() for _ in range(mix.slots)]
        later = [st.next().out_len for _ in range(mix.block)]
        return first, later
    (a, later), (b, _) = fill(5), fill(2**31 + 3)
    assert min(r.out_len for r in a) < mix.output_tokens["lo"]
    assert min(later) >= mix.output_tokens["lo"]
    assert sorted(r.out_len for r in a) == sorted(r.out_len for r in b)
    assert sorted(len(r.prompt) for r in a) == \
        sorted(len(r.prompt) for r in b)
    assert [r.prompt for r in a] != [r.prompt for r in b]


def test_warm_lengths_cover_every_shape():
    for name in ("decode_backlog", "completion_open"):
        mix = traffic.Mix.load(spec.traffic_path(name))
        got = traffic.warm_prompt_lengths(mix)
        lo, hi = mix.prompt_tokens["lo"], mix.prompt_tokens["hi"]

        def w(p):
            return min(mix.max_len, max(8, 1 << (p - 1).bit_length()))

        def c(p):
            pages = -(-(p + mix.max_new) // mix.page_size)
            return min(mix.max_pages, max(2, 1 << (pages - 1).bit_length()))
        assert {w(p) for p in got} == {w(p) for p in range(lo, hi + 1)}
        assert {c(p) for p in got} == {c(p) for p in range(lo, hi + 1)}


def test_undroppable_slots():
    port = json.loads((spec.HERE / "configs" /
                       "moonshot-v1-16b-a3b.json").read_text())["port"]
    # decode: int(64 x 6 x 1.25 / 64) = 7 places; a join: 7.5 W // W = 7
    assert check.undroppable_slots(port, 64, 1536) == 7
    dense = dict(port, moe=None)
    assert check.undroppable_slots(dense, 64, 1536) == 64
    roomy = dict(port, moe=dict(port["moe"], capacity_factor=64 / 6 + 1))
    assert check.undroppable_slots(roomy, 64, 1536) == 64


def test_every_name_resolves():
    bench = spec.load_benchmark()
    metrics = spec.metrics(bench)
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert spec.traffic_path(w["traffic"]).is_file()
        traffic.Mix.load(spec.traffic_path(w["traffic"]))
        assert cell.port["n_layers"] == sum(n for _, n in
                                            cell.port["segments"])
        assert cell.metrics_e2e and cell.metrics_layer
        assert any(m.name == "setup_s" for m in cell.metrics_e2e)
    for m in metrics:
        assert hasattr(m.reader(), "read"), m.name
        if m.kind == "per_layer":
            target = next(t for t in metrics if t.name == m.moves)
            assert target.kind == "end_to_end"
            for w in m.workloads or [x["name"] for x in bench["workloads"]]:
                assert target.applies(w), (m.name, w)
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] == \
            c["name"]


def test_limits_sit_between_their_readings():
    for w in spec.load_benchmark()["workloads"]:
        limits = spec.cell(w["name"]).limits
        compared = [limits[k] for k in check.STATS if k in limits]
        assert compared, w["name"]
        for lim in compared:
            assert lim["lower"] < lim["limit"] < lim["upper"]
            assert lim["upper"] >= 3 * lim["lower"]
            assert math.isfinite(lim["limit"])


def test_sample_reads_in_flight_requests_when_few_finished():
    """Few requests of the first slots finish in a backlog's window: the
    sample then adds the tokens that requests in flight had served."""
    import types
    mix = traffic.Mix.load(spec.traffic_path("decode_backlog"))

    def req(rid, slot, served, done):
        r = traffic.Request(rid, [1] * 300, 500)
        return types.SimpleNamespace(r=r, plen=300, slot=slot, served=served,
                                     t_done=done, t_arrival=0.0)
    port = spec.cell("moonshot.decode_backlog").port
    reqs = [req(1, 0, [5] * 40, 11.0), req(2, 3, [5] * 30, 12.0),
            req(3, 30, [5] * 400, 12.0),          # a slot drops can reach
            req(4, 5, [5] * 300, None), req(5, 6, [5] * 90, None)]
    session = types.SimpleNamespace(mix=mix, w0=10.0, w1=60.0,
                                    window_reqs=lambda: reqs)
    got = check.sample(session, 3, 2, port, min_tokens=200)
    assert got[0].r.rid == 1                      # the longest finished
    assert {q.r.rid for q in got} >= {1, 2}
    assert sum(len(q.served) for q in got) >= 200
    assert all(q.slot < 7 for q in got)
