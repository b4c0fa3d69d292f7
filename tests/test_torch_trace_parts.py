"""The traced batcher's inner spans, work counts and device intervals, on
reduced moonshot-v1-16b-a3b (1 dense + 2 MoE layers, float32, the CPU)
through the paged batcher:

- traced and untraced runs give equal tokens, and neither calls
  ``torch.cuda.synchronize``;
- each join holds one ``moe.route``, ``moe.dispatch``, ``moe.experts``,
  ``moe.combine`` and ``moe.shared`` a MoE layer, one ``attn`` (holding one
  ``attn.core``) a layer, one ``mlp`` a dense layer and one ``readout``,
  the join their parent; each round holds its ``sweep``, ``admit`` and the
  JAX-shaped spans (``span_links``);
- the join's ``rows``, ``width``, ``joined``, ``real_tokens`` and
  ``committed`` and the segment's ``steps``, ``live_rows``, ``kv_tokens``
  and ``tokens`` equal counts made from the join's and the loop's device
  inputs and from the requests;
- a fake device timer: the anchor mapping (forward, and back for marks
  before the first anchor), a round's idle seconds by child, the Perfetto
  ``model`` and ``device`` tracks, and :meth:`Tracer.summary` on a
  hand-built trace against hand-computed values;
- tracing off: nothing is armed in the join and the hook returns its one
  null context."""
import numpy as np
import pytest
import torch

from repro_torch import parthook
from repro_torch.configs import get_config
from repro_torch.configs.base import BlockKind
from repro_torch.models.init import init_params
from repro_torch.models.model_zoo import Model
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Batcher
from repro_torch.serve.telemetry import Tracer

torch.set_num_threads(1)

SERVE = dict(max_len=64, batch=4, dtype=torch.float32, sync_every=4,
             paged=True, page_size=8)
MAX_NEW = 7
MOE_PARTS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
             "moe.shared")


class Probe(Batcher):
    """The batcher, recording each join's and decode segment's device
    inputs as the model receives them."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.join_inputs: list[tuple] = []
        self.segment_inputs: list[tuple] = []
        join = self._join

        def spy(params, caches, tok, lengths, done, remaining, join_mask,
                prompts, plens, *rest):
            self.join_inputs.append((join_mask.clone(), prompts.shape,
                                     plens.clone(), rest[-1].clone(),
                                     parthook._recorder))
            return join(params, caches, tok, lengths, done, remaining,
                        join_mask, prompts, plens, *rest)
        self._join = spy

    def _decode_segment(self, steps):
        self.segment_inputs.append((steps, self.lengths.clone(),
                                    self.done.clone(),
                                    self.remaining.clone()))
        return super()._decode_segment(steps)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    return cfg, init_params(cfg, 0, device="cpu")


def _requests(cfg, n=7, seed=3):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, cfg.vocab,
                               size=int(rng.integers(5, 21))).tolist())
            for rid in range(n)]


def _serve(setup, telemetry, monkeypatch, tracer=None):
    cfg, params = setup
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1))
    b = Probe(Model(cfg), params,
              ServeConfig(**SERVE, telemetry=telemetry), telemetry=tracer)
    for rid, p in _requests(cfg):
        b.submit(rid, p)
    b.run(max_new=MAX_NEW)
    monkeypatch.undo()
    return b, len(syncs)


@pytest.fixture(scope="module")
def served(setup):
    mp = pytest.MonkeyPatch()
    on, on_syncs = _serve(setup, True, mp)
    off, off_syncs = _serve(setup, False, mp)
    return on, off, on_syncs, off_syncs


def _children(tr, parent_id):
    return [r for r in tr.inner if r["parent"] == parent_id]


def test_traced_tokens_equal_untraced_and_no_sync(served):
    on, off, on_syncs, off_syncs = served
    assert on.results == off.results
    assert len(on.results) == 7
    assert on_syncs == off_syncs == 0
    assert off.telemetry is None


def test_each_join_holds_the_models_parts(served, setup):
    cfg = setup[0]
    tr = served[0].telemetry
    n_moe = sum(s.count for s in cfg.resolved_segments()
                if s.kind is BlockKind.MOE)
    n_dense = cfg.n_layers - n_moe
    joins = [(sid, sp) for (sid, _), sp in zip(tr.span_links, tr.spans)
             if sp["name"] == "join"]
    assert len(joins) == served[0].joins >= 2
    for sid, sp in joins:
        kids = _children(tr, sid)
        names = [k["name"] for k in kids]
        for name in MOE_PARTS:
            assert names.count(name) == n_moe, name
        assert names.count("attn") == cfg.n_layers
        assert names.count("mlp") == n_dense
        assert names.count("readout") == 1
        assert len(names) == len(MOE_PARTS) * n_moe + cfg.n_layers \
            + n_dense + 1
        for k in kids:
            assert k["round"] == sp["round"]
            assert sp["t0"] <= k["t0"] <= k["t1"] <= sp["t1"]
            assert "d0" not in k            # no device timer on the CPU
            inner = [c["name"] for c in _children(tr, k["id"])]
            assert inner == (["attn.core"] if k["name"] == "attn" else [])


def test_rounds_parent_their_spans(served):
    tr = served[0].telemetry
    rounds = {r["id"]: r for r in tr.inner if r["name"] == "round"}
    assert len(rounds) == served[0].round
    for (sid, parent), sp in zip(tr.span_links, tr.spans):
        rnd = rounds[parent]
        assert rnd["round"] == sp["round"]
        assert rnd["t0"] <= sp["t0"] <= sp["t1"] <= rnd["t1"]
    for rid, rnd in rounds.items():
        names = [k["name"] for k in _children(tr, rid)]
        assert names[0] == "sweep" and names.count("admit") == 1
        assert "idle_s" not in rnd          # no device timer on the CPU
    ids = [r["id"] for r in tr.inner] + [sid for sid, _ in tr.span_links]
    assert len(ids) == len(set(ids))


def test_join_and_segment_work_counts(served, setup):
    b = served[0]
    cfg = setup[0]
    joins = [sp for sp in b.telemetry.spans if sp["name"] == "join"]
    assert len(joins) == len(b.join_inputs)
    for sp, (mask, shape, plens, commit, _) in zip(joins, b.join_inputs):
        assert (sp["rows"], sp["width"]) == tuple(shape) == (4, sp["width"])
        assert sp["joined"] == int(mask.sum())
        assert sp["real_tokens"] == int(plens[mask].sum())
        assert sp["committed"] == int(commit.sum())
    # unchunked, no prefix cache: every prompt token is computed once
    assert sum(sp["real_tokens"] for sp in joins) == sum(
        len(p) for _, p in _requests(cfg))
    segs = [sp for sp in b.telemetry.spans if sp["name"] == "decode-segment"]
    assert len(segs) == len(b.segment_inputs) == b.segments
    for sp, (steps, lengths, done, remaining) in zip(segs, b.segment_inputs):
        live = ~done
        n = torch.minimum(torch.minimum(remaining, SERVE["max_len"]
                                        - lengths), torch.tensor(steps))
        n = torch.where(live, n.clamp_min(0), 0).long()
        kv = n * lengths.long() + n * (n + 1) // 2
        assert sp["steps"] == steps
        assert sp["live_rows"] == int(live.sum())
        assert sp["kv_tokens"] == int(kv.sum())
    # each request's first token comes from its join, the rest from
    # segments
    assert sum(sp["tokens"] for sp in segs) == sum(
        len(v) for v in b.results.values()) - len(b.results)


def test_untraced_join_arms_nothing(served):
    off = served[1]
    assert off.join_inputs and all(
        rec is None for *_, rec in off.join_inputs)
    assert all(rec is not None for *_, rec in served[0].join_inputs)
    assert parthook._recorder is None
    assert parthook.part("attn") is parthook.NULL
    assert parthook.part("moe.dispatch") is parthook.NULL


# ---------------------------------------------------------------------------
# a fake device timer
# ---------------------------------------------------------------------------

class FakeTimer:
    """Device marks read off a settable device clock."""

    def __init__(self):
        self.now = 0.0
        self.capture = False

    def mark(self):
        return self.now

    @staticmethod
    def seconds(a, b):
        return b - a

    def release(self, mark):
        pass

    def capturing(self):
        return self.capture


def _fake():
    host = [0.0]
    dev = FakeTimer()
    tr = Tracer(clock=lambda: host[0], device_timer=dev)
    return tr, host, dev


def test_anchor_maps_marks_onto_the_host_clock():
    tr, host, dev = _fake()
    a = tr.open("join", 1)
    dev.now = 100.0
    tr.mark(a, "d0")                  # before any anchor
    dev.now = 102.0
    tr.mark(a, "d1")
    host[0], dev.now = 10.0, 103.0
    tr.device_sync()                  # the first anchor: (103, 10)
    assert a["d0"] is None and a["d1"] is None
    tr.close(a)
    b = tr.open("decode-segment", 1)
    dev.now = 104.5
    tr.mark(b, "d0")
    dev.now = 107.25
    tr.mark(b, "d1")
    host[0], dev.now = 20.0, 110.0
    tr.device_sync()                  # the second: (110, 20)
    tr.close(b)
    assert (a["d0"], a["d1"]) == (7.0, 9.0)       # back from (103, 10)
    assert (b["d0"], b["d1"]) == (11.5, 14.25)    # on from (103, 10)
    c = tr.open("join", 2)
    dev.now = 111.0
    tr.mark(c, "d0")
    host[0], dev.now = 30.0, 115.0
    tr.device_sync()
    assert c["d0"] == 21.0                        # on from (110, 20)
    assert list(tr.spans) == [a, b]
    assert set(a) == {"name", "round", "t0", "t1", "d0", "d1"}


def test_part_is_the_null_context_while_capturing():
    tr, _, dev = _fake()
    dev.capture = True
    assert tr.part("attn") is parthook.NULL
    dev.capture = False
    with tr.part("attn") as rec:
        pass
    assert tr.inner == [rec] and "d0" in rec


def _hand_trace():
    """Two rounds on a fake device: round 1 (host 0-10) joins (host 2-8,
    device 3-7, parts attn 3-5 holding attn.core 3.5-4.5, moe.dispatch
    5-6.5) and decodes (host 8-9.5, device 8.25-9.25, 4 steps); round 2
    (host 10-12) only decodes (host 10.5-11.5, device 10.75-11.25, 4
    steps)."""
    tr, host, dev = _fake()
    host[0] = dev.now = 0.0
    tr.device_sync()                            # anchor (0, 0)

    def at(t):
        host[0] = t

    def mark(rec, key, t):
        dev.now = t
        tr.mark(rec, key)

    with tr.round_span(1) as r1:
        at(0.5)
        with tr.inner_span("sweep", 1):
            at(1.0)
        at(2.0)
        j = tr.open("join", 1)
        mark(j, "d0", 3.0)
        with tr.part("attn") as attn:        # a part marks its entry and
            dev.now = 3.5                     # exit at the device's now
            with tr.part("attn.core") as core:
                dev.now = 4.5
            dev.now = 5.0
        with tr.part("moe.dispatch") as disp:
            dev.now = 6.5
        mark(j, "d1", 7.0)
        at(7.5)
        dev.now = 7.5
        tr.device_sync()
        tr.close(j, t1=8.0, rows=4, width=16, joined=2, real_tokens=20,
                 committed=2)
        s = tr.open("decode-segment", 1, t0=8.0)
        mark(s, "d0", 8.25)
        mark(s, "d1", 9.25)
        tr.close(s, t1=9.5, steps=4, live_rows=2, kv_tokens=100)
        at(9.5)
        dev.now = 9.5
        tr.device_sync()
        at(10.0)
    with tr.round_span(2) as r2:
        s2 = tr.open("decode-segment", 2, t0=10.5)
        mark(s2, "d0", 10.75)
        mark(s2, "d1", 11.25)
        tr.close(s2, t1=11.5, steps=4, live_rows=2, kv_tokens=108)
        dev.now = 11.5
        at(11.5)
        tr.device_sync()
        at(12.0)
    return tr, r1, r2


def test_round_idle_by_child_span():
    tr, r1, r2 = _hand_trace()
    # round 1 [0, 10] less the device [3, 7] and [8.25, 9.25]
    assert r1["idle_s"] == pytest.approx(3.0 + 1.25 + 0.75)
    assert r1["idle"] == pytest.approx({"round": 2.0, "sweep": 0.5,
                                        "join": 2.0, "decode-segment": 0.5})
    assert r2["idle_s"] == pytest.approx(1.5)
    assert r2["idle"] == pytest.approx({"round": 1.0,
                                        "decode-segment": 0.5})


def test_summary_on_a_hand_built_trace():
    tr, _, _ = _hand_trace()
    got = tr.summary()
    assert got["join.device_ms_mean"] == pytest.approx(4000.0)
    assert got["join.useful_token_share"] == pytest.approx(100 * 20 / 64)
    assert got["moe.dispatch_share"] == pytest.approx(100 * 1.5 / 4)
    assert got["join.attn_share"] == pytest.approx(100 * 1.0 / 4)
    assert got["join.parts_share"] == pytest.approx(100 * 3.5 / 4)
    assert got["decode.device_step_ms"] == pytest.approx(
        (1.0 + 0.5) / 8 * 1e3)
    # round 1: 10 less join 6 and segment 1.5; round 2: 2 less 1
    assert got["sched.round_self_ms"] == pytest.approx(
        (2.5 + 1.0) / 2 * 1e3)
    assert got["idle_share"] == pytest.approx(100 * 6.5 / 12)
    # a window that starts in round 2 reads round 2 alone
    late = tr.summary(10.0, 20.0)
    assert late["join.device_ms_mean"] is None
    assert late["moe.dispatch_share"] is None
    assert late["decode.device_step_ms"] == pytest.approx(0.5 / 4 * 1e3)
    assert late["sched.round_self_ms"] == pytest.approx(1000.0)
    assert late["idle_share"] == pytest.approx(100 * 9.5 / 10)


def test_perfetto_model_and_device_tracks():
    tr, _, _ = _hand_trace()
    ev = tr.to_perfetto()["traceEvents"]
    threads = {e["tid"]: e["args"]["name"] for e in ev
               if e.get("name") == "thread_name"}
    assert threads[2] == "model" and threads[3] == "device"
    model = [e for e in ev if e.get("tid") == 2 and e["ph"] == "X"]
    assert [e["name"] for e in model] == [
        "round", "sweep", "attn", "attn.core", "moe.dispatch", "round"]
    assert model[0]["args"]["idle"]["join"] == pytest.approx(2.0)
    device = {(e["name"], e["ts"], e["dur"]) for e in ev
              if e.get("tid") == 3 and e["ph"] == "X"}
    assert device == {("join", 3e6, 4e6), ("decode-segment", 8.25e6, 1e6),
                      ("decode-segment", 10.75e6, 0.5e6),
                      ("attn", 3e6, 2e6), ("attn.core", 3.5e6, 1e6),
                      ("moe.dispatch", 5e6, 1.5e6)}
    sched = [e for e in ev if e.get("tid") == 0 and e["ph"] == "X"]
    assert sched[0]["args"] == {"round": 1, "d0": 3.0, "d1": 7.0,
                                "rows": 4, "width": 16, "joined": 2,
                                "real_tokens": 20, "committed": 2}


def test_untraced_tracer_has_no_device_keys():
    tr = Tracer(clock=iter([0.0, 1.0, 2.0, 3.0]).__next__)
    with tr.round_span(1) as rnd:
        tr.add_span("join", 1, 1.0, 2.0)
    assert tr.spans == [{"name": "join", "round": 1, "t0": 1.0, "t1": 2.0}]
    assert tr.span_links == [(1, rnd["id"])]
    assert "idle_s" not in rnd
    tr.device_sync()                  # no timer: nothing to map
    assert tr.summary()["idle_share"] is None
