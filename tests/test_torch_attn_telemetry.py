"""The port's attention telemetry, routing policy and amenability reports
against the JAX package: ``_traffic`` exactly equal to JAX's for decode,
prefill and verify with concrete and with abstract (captured) metadata;
the telemetry's counters per (op, route) after the same sequence of calls
(JAX ``test_telemetry.py``'s kernel-hook cases; JAX's ``xla`` route is
the port's ``plain``); the amenability verdicts and op/byte; the copies
of ``core/hwspec.py`` and ``core/amenability.py`` held to
``test_amenability.py``'s cases through both packages; on the CPU,
``attn_mode="plain"`` and ``"auto"`` give equal float32 greedy streams
and statistics from the paged batcher (as JAX's ``test_serve_paged.py``
does for ``xla`` and ``kernel``), and ``"kernel"`` on a CPU tensor
raises.  A captured call is simulated by patching the ops' capture test:
a CPU build of PyTorch cannot capture a graph."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amenability as jam
from repro.core import hwspec as jhw
from repro.core.primitives import push, ss_gemm, vector_sum, wavesim
from repro.core.primitives.graphs import powerlaw
from repro.kernels.paged_attn import (amenability_reports as jax_reports,
                                      attn_telemetry as jax_telemetry)
from repro.kernels.paged_attn import ops as jops
from repro_torch.configs import get_config
from repro_torch.core import amenability as am
from repro_torch.core import hwspec as hw
from repro_torch.kernels.decode_attn import decode_attn, decode_attn_policy
from repro_torch.kernels.paged_attn import (amenability_reports,
                                            attn_telemetry, paged_attn,
                                            paged_attn_gather,
                                            paged_prefill_attn,
                                            paged_verify_attn)
from repro_torch.kernels.paged_attn import ops
from repro_torch.models.model_zoo import Model
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Batcher

torch.set_num_threads(1)

COUNTERS = ("calls", "traced_calls", "tokens", "bytes", "flops",
            "onchip_bytes", "timed_bytes")


def _inputs(seed=0, dtype=np.float32, n=6, ps=4, hkv=2, d=8, b=2, p=3,
            hq=4, lq=3):
    rng = np.random.default_rng(seed)
    return dict(kp=rng.normal(size=(n, ps, hkv, d)).astype(dtype),
                tbl=rng.integers(0, n, size=(b, p)).astype(np.int32),
                ln=np.asarray(rng.integers(0, p * ps + 1, size=b),
                              np.int32),
                q1=rng.normal(size=(b, hq, d)).astype(dtype),
                q3=rng.normal(size=(b, lq, hq, d)).astype(dtype))


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


@pytest.fixture
def telemetry():
    jt, pt = jax_telemetry(), attn_telemetry()
    for t in (jt, pt):
        t.reset()
        t.enable()
    yield jt, pt
    for t in (jt, pt):
        t.disable()
        t.reset()


# --------------------------------------------------------------------------
# _traffic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bf16", [False, True])
def test_traffic_equals_jax_concrete_and_abstract(seed, bf16):
    x = _inputs(seed)
    jkp, kp = _both(x["kp"])
    jtb, tb = _both(x["tbl"])
    jln, ln = _both(x["ln"])
    if bf16:
        jkp, kp = jkp.astype(jnp.bfloat16), kp.to(torch.bfloat16)
    jq1, q1 = _both(x["q1"])
    jq3, q3 = _both(x["q3"])
    off = np.maximum(x["ln"] - 3, 0).astype(np.int32)
    joff, toff = _both(off)
    cases = [(jq1, q1, None, None), (jq3, q3, joff, toff),
             (jq3, q3, jln, ln)]                      # decode, prefill, verify
    for jq, q, jo, o in cases:
        want = jops._traffic(jq, jkp, jtb, jln, q_offset=jo)
        got = ops._traffic(q, kp, tb, ln, o)
        assert got == want
        # abstract: the lengths (and offsets) are traced values in JAX and
        # device values a capture must not read in the port
        seen = {}

        def f(ln_, off_, jq=jq, jo=jo):
            seen["t"] = jops._traffic(jq, jkp, jtb, ln_,
                                      q_offset=None if jo is None else off_)
            return ln_
        jax.jit(f)(jln, jln if jo is None else jo)
        assert ops._traffic(q, kp, tb, ln, o, concrete=False) == seen["t"]


# --------------------------------------------------------------------------
# the counters after the same sequence of calls
# --------------------------------------------------------------------------

def _sequence(telemetry, monkeypatch):
    """JAX test_telemetry.py's kernel-hook calls on both packages: the
    gather decode, a prefill, a verify and a traced/captured prefill."""
    x = _inputs(0)
    ln = np.asarray([5, 9], np.int32)
    jkp, kp = _both(x["kp"])
    jtb, tb = _both(x["tbl"])
    jln, tln = _both(ln)
    jq1, q1 = _both(x["q1"])
    jq3, q3 = _both(x["q3"])
    jops.paged_attn_xla(jq1, jkp, jkp, jtb, jln)
    jops.paged_prefill_attn(jq3, jkp, jkp, jtb, jln - 3, jln)
    jops.paged_verify_attn(jq3, jkp, jkp, jtb, jln, jln)
    jax.jit(lambda q: jops.paged_prefill_attn(q, jkp, jkp, jtb, jln - 3,
                                              jln))(jq3).block_until_ready()
    paged_attn_gather(q1, kp, kp, tb, tln)
    paged_attn(q1, kp, kp, tb, tln)                 # auto on the CPU: plain
    jops.paged_attn_xla(jq1, jkp, jkp, jtb, jln)
    paged_prefill_attn(q3, kp, kp, tb, tln - 3, tln)
    paged_verify_attn(q3, kp, kp, tb, tln, tln)
    monkeypatch.setattr(ops, "_capturing", lambda device: True)
    paged_prefill_attn(q3, kp, kp, tb, tln - 3, tln)
    monkeypatch.undo()


def test_counters_equal_jax_after_the_same_calls(telemetry, monkeypatch):
    jt, pt = telemetry
    _sequence(telemetry, monkeypatch)
    want = {k.replace(".xla", ".plain"): v for k, v in jt.snapshot().items()}
    got = pt.snapshot()
    assert set(got) == set(want) == {"decode.plain", "prefill.plain",
                                     "verify.plain"}
    for key in want:
        for c in COUNTERS:
            assert got[key][c] == want[key][c], (key, c)
        assert got[key]["op_byte"] == want[key]["op_byte"]
    assert got["prefill.plain"]["traced_calls"] == 1
    assert got["decode.plain"]["calls"] == 2
    for row in got.values():                       # eager calls are timed
        assert row["wall_s"] > 0.0


def test_amenability_reports_equal_jax(telemetry, monkeypatch):
    _sequence(telemetry, monkeypatch)
    want, got = jax_reports(), amenability_reports()
    assert set(got) == set(want) == {"decode", "prefill", "verify"}
    for op in want:
        assert got[op].verdict.value == want[op].verdict.value
        assert got[op].profile.op_byte == want[op].profile.op_byte
        assert [(c.passed, c.evidence) for c in got[op].characteristics] == \
            [(c.passed, c.evidence) for c in want[op].characteristics]
        assert got[op].guidance == want[op].guidance


def test_hooks_off_record_nothing():
    tel = attn_telemetry()
    tel.disable()
    tel.reset()
    x = _inputs(0)
    paged_attn(*(torch.from_numpy(x[k]) for k in ("q1", "kp", "kp", "tbl",
                                                   "ln")))
    assert tel.stats == {} and amenability_reports() == {}


# --------------------------------------------------------------------------
# the hwspec and amenability copies, through test_amenability.py's cases
# --------------------------------------------------------------------------

def _port_profile(p):
    return am.PrimitiveProfile(
        name=p.name, ops=p.ops, mem_bytes=p.mem_bytes,
        onchip_bytes=p.onchip_bytes,
        interaction=am.Interaction(p.interaction.value),
        alignable=p.alignable,
        input_dependent_locality=p.input_dependent_locality, notes=p.notes)


def test_hwspec_copies_equal_jax():
    for mine, theirs in ((hw.PimSpec(), jhw.PimSpec()),
                         (hw.GpuSpec(), jhw.GpuSpec())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    p, jp = hw.PimSpec(), jhw.PimSpec()
    for name in ("pch_per_stack", "t_ccds_ns", "banks_per_subset",
                 "cols_per_row", "broadcast_bytes_per_cmd", "pim_peak_gbps",
                 "regular_bytes_per_ns_per_pch", "row_cycle_ns",
                 "row_switch_ns"):
        assert getattr(p, name) == getattr(jp, name), name
    assert hw.GpuSpec().effective_gbps == jhw.GpuSpec().effective_gbps
    h = hw.HopperSpec()
    assert (h.sms, h.hbm_gbps, h.max_cluster) == (132, 3350.0, 8)
    assert h.peak_flops_per_ns("bfloat16") == 989e3


@pytest.mark.parametrize("name", ["vector_sum", "compute_bound", "push",
                                  "ssgemm", "wavesim_volume",
                                  "wavesim_flux"])
def test_amenability_copy_equals_jax(name):
    profiles = {
        "vector_sum": lambda: vector_sum.profile(
            vector_sum.Problem(1 << 20)),
        "compute_bound": lambda: jam.PrimitiveProfile(
            "big-gemm", ops=1e12, mem_bytes=1e6, onchip_bytes=1e9,
            interaction=jam.Interaction.LOCALIZED, alignable=True),
        "push": lambda: push.profile(powerlaw(100_000, 1_000_000)),
        "ssgemm": lambda: ss_gemm.profile(ss_gemm.Problem(n=4)),
        "wavesim_volume": lambda: wavesim.profile_volume(wavesim.Problem()),
        "wavesim_flux": lambda: wavesim.profile_flux(wavesim.Problem())}
    jp = profiles[name]()
    want = jam.run_test(jp)
    got = am.run_test(_port_profile(jp), hw.PimSpec(), hw.GpuSpec())
    assert got.verdict.value == want.verdict.value
    assert got.summary() == want.summary()
    assert got.profile.op_byte == want.profile.op_byte
    assert am.pim_bandwidth_multiplier(hw.PimSpec(), hw.GpuSpec()) == \
        jam.pim_bandwidth_multiplier(jhw.PimSpec(), jhw.GpuSpec())


# --------------------------------------------------------------------------
# routing: plain against auto on the CPU, kernel refused there
# --------------------------------------------------------------------------

def _serve(model, params, mode, requests):
    b = Batcher(model, params, ServeConfig(
        max_len=64, batch=3, dtype=torch.float32, sync_every=4, paged=True,
        page_size=8, attn_mode=mode))
    for rid, p in requests:
        b.submit(rid, p)
    return b.run(max_new=8), b


def test_plain_and_auto_serve_equal_streams_on_the_cpu():
    cfg = get_config("qwen2-0.5b").reduced()
    model = Model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    requests = [(i, rng.integers(0, cfg.vocab,
                                 size=int(rng.integers(3, 12))).tolist())
                for i in range(5)]
    got_p, bp = _serve(model, params, "plain", requests)
    got_a, ba = _serve(model, params, "auto", requests)
    assert got_p == got_a
    assert bp.admit_order == ba.admit_order
    assert (bp.joins, bp.segments) == (ba.joins, ba.segments)
    assert bp.kv_utilization() == ba.kv_utilization()
    lp, la = bp.latency_stats(), ba.latency_stats()
    assert lp["requests"] == la["requests"]


def test_kernel_mode_on_a_cpu_tensor_raises():
    x = _inputs(0)
    args = [torch.from_numpy(x[k]) for k in ("q1", "kp", "kp", "tbl", "ln")]
    with decode_attn_policy(mode="kernel"):
        with pytest.raises(RuntimeError, match="CPU"):
            paged_attn(*args)
        with pytest.raises(RuntimeError, match="CPU"):
            paged_prefill_attn(torch.from_numpy(x["q3"]), *args[1:4],
                               args[4] - 3, args[4])
        kv = torch.zeros(2, 16, 2, 8)
        with pytest.raises(RuntimeError, match="CPU"):
            decode_attn(args[0], kv, kv, args[4])
    cfg = get_config("qwen2-0.5b").reduced()
    model = Model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CPU"):
        _serve(model, params, "kernel", [(0, [1, 2, 3])])
    with pytest.raises(ValueError, match="attention mode"):
        ServeConfig(max_len=8, batch=1, attn_mode="xla")
