"""PIM-offload planner: the paper's §3 methodology over LM steps, from
:mod:`repro.core.planner`.

Given an arch config and a shape cell, the planner decomposes the step
into the op classes the framework knows (attention score/AV, FFN GEMMs,
MoE dispatch+expert GEMMs, embedding/LM-head, SSD scan, KV-cache
streaming), runs the PIM-amenability-test on each (op/byte vs the ridge,
residency, operand locality, alignment), and emits:

* the ops that would profit from PIM-style treatment on the strawman PIM
  system (with estimated speedups from the analytical §4.3 model), and
* the action the port takes for each on the H100 (which hand-written
  kernel or schedule applies).

Two departures from the JAX module, both deliberate: the speedup estimate
derates by the H100's bf16 ridge (:data:`RIDGE_OP_BYTE`, from
:class:`~.hwspec.HopperSpec`) where JAX's derates by its TPU's, and each
op's ``gpu_action`` names the port's route where JAX's ``tpu_action``
names a Pallas kernel.  The op counts, bytes and verdicts are JAX's.

  python -m repro_torch.launch.offload_planner --arch <id>
"""
from __future__ import annotations

import dataclasses

from .amenability import (AmenabilityReport, Interaction, PrimitiveProfile,
                          Verdict, run_test)
from .hwspec import DEFAULT_GPU, DEFAULT_HOPPER, DEFAULT_PIM
from ..configs.base import ArchConfig, BlockKind, ShapeConfig

ELEM = 2  # bf16

# The compute/memory ridge :func:`plan` derates by: the card's bf16 peak
# over its HBM rate (FLOP per byte).  Read when ``plan`` runs.
RIDGE_OP_BYTE = DEFAULT_HOPPER.ridge_op_byte


@dataclasses.dataclass(frozen=True)
class OpClass:
    name: str
    ops: float                  # flops (global, per step)
    mem_bytes: float            # unavoidable HBM traffic
    onchip_bytes: float         # traffic served by reuse if cached
    interaction: Interaction
    alignable: bool
    input_dependent: bool
    gpu_action: str             # what the port does about it on the H100


def decompose(cfg: ArchConfig, shape: ShapeConfig) -> list[OpClass]:
    t = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    d = cfg.d_model
    ctx = shape.seq_len
    out: list[OpClass] = []
    n_attn = sum(s.count for s in cfg.resolved_segments()
                 if s.kind in (BlockKind.DENSE, BlockKind.MOE))
    n_dense = sum(s.count for s in cfg.resolved_segments()
                  if s.kind is BlockKind.DENSE)
    n_moe = sum(s.count for s in cfg.resolved_segments()
                if s.kind is BlockKind.MOE)
    n_ssm = sum(s.count for s in cfg.resolved_segments()
                if s.kind is BlockKind.SSM)

    if n_attn and cfg.attn.value != "none" and shape.kind == "decode":
        hd = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim if cfg.mla
              else cfg.kv_heads * cfg.resolved_head_dim)
        cache_bytes = shape.global_batch * ctx * hd * ELEM * n_attn
        flops = 2.0 * t * ctx * cfg.n_heads * (
            cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim if cfg.mla
            else 2 * cfg.resolved_head_dim) * n_attn
        out.append(OpClass(
            "decode-attention (KV stream)", flops, cache_bytes, t * d * ELEM,
            Interaction.LOCALIZED, True, False,
            "kernels/decode_attn, paged_attn: split-KV walk of "
            "decode_split.cuh, one thread-block cluster merging in "
            "distributed shared memory"))
    if n_attn and cfg.attn.value != "none" and shape.kind != "decode":
        flops = 4.0 * t * (ctx / 2) * cfg.n_heads * cfg.resolved_head_dim \
            * n_attn * (3 if shape.kind == "train" else 1)
        out.append(OpClass(
            "attention scores/AV", flops, t * d * ELEM * n_attn * 2,
            flops / 100, Interaction.LOCALIZED, True, False,
            "paged prefill on the tensor cores (paged_prefill_tc.cu); "
            "cache-free calls the blockwise core — compute-bound"))
    if n_dense:
        mult = 3 if cfg.gated_mlp else 2
        flops = (6.0 if shape.kind == "train" else 2.0) \
            * t * mult * d * cfg.d_ff * n_dense
        w_bytes = mult * d * cfg.d_ff * n_dense * ELEM
        act_bytes = t * (d + cfg.d_ff) * n_dense * ELEM
        out.append(OpClass(
            "dense FFN", flops,
            w_bytes if shape.kind == "decode" else w_bytes + act_bytes,
            t * d * ELEM * n_dense, Interaction.INDUCIBLE, True, False,
            "bf16 GEMM on the tensor cores (torch.matmul); weights "
            "streamed from HBM at decode"))
    if cfg.moe and n_moe:
        m = cfg.moe
        flops = (6.0 if shape.kind == "train" else 2.0) \
            * t * m.top_k * 3 * d * m.d_ff_expert * n_moe
        w_bytes = m.n_experts * 3 * d * m.d_ff_expert * n_moe * ELEM
        out.append(OpClass(
            "MoE expert GEMMs (dynamic-sparse skinny)", flops,
            min(w_bytes, flops / (2 * 128)),
            t * d * ELEM, Interaction.INDUCIBLE, True, True,
            "kernels/moe_group_gemm: dead-tile skip of group_gemm.cu "
            "(tiles past each expert's count read nothing; = §5.1.2 "
            "command skipping)"))
    if cfg.ssm and n_ssm:
        s = cfg.ssm
        d_inner = s.expand * d
        flops = (6.0 if shape.kind == "train" else 2.0) \
            * t * (2 * d * d_inner + d_inner * s.d_state * 2) * n_ssm
        state_bytes = shape.global_batch * (d_inner * s.d_state) * 4 * n_ssm
        out.append(OpClass(
            "SSD scan (state update)", flops,
            state_bytes if shape.kind == "decode"
            else t * d_inner * ELEM * n_ssm * 3,
            t * d * ELEM, Interaction.SINGLE_OPERAND, True, False,
            "chunked SSD in PyTorch ops (matmul form); decode = in-place "
            "state RMW (the push-primitive pattern)"))
    # embedding / LM head
    head_flops = 2.0 * t * d * cfg.vocab * (3 if shape.kind == "train" else 1)
    out.append(OpClass(
        "LM head / embedding", head_flops,
        (cfg.vocab * d * ELEM if shape.kind == "decode"
         else t * d * ELEM + cfg.vocab * d * ELEM),
        t * d * ELEM, Interaction.REDUCTION, True, False,
        "chunked loss (chunked_xent: logits of 1,024 positions at a "
        "time); one card, not vocab-sharded"))
    return out


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    op: OpClass
    report: AmenabilityReport
    op_byte: float
    est_pim_speedup: float


def plan(cfg: ArchConfig, shape: ShapeConfig) -> list[PlanEntry]:
    entries = []
    for op in decompose(cfg, shape):
        profile = PrimitiveProfile(
            name=op.name, ops=op.ops, mem_bytes=op.mem_bytes,
            onchip_bytes=max(1.0, op.onchip_bytes),
            interaction=op.interaction, alignable=op.alignable,
            input_dependent_locality=op.input_dependent)
        report = run_test(profile, DEFAULT_PIM, DEFAULT_GPU)
        ob = profile.op_byte
        # §4.3-style estimate: bandwidth-bound ops gain PIM_BW/GPU_BW,
        # derated by how far above pure-streaming the op/byte sits.
        if report.verdict is Verdict.NOT_AMENABLE:
            est = 1.0
        else:
            bw_gain = DEFAULT_PIM.pim_peak_gbps / DEFAULT_GPU.effective_gbps
            ridge = RIDGE_OP_BYTE
            est = max(1.0, bw_gain * min(1.0, ridge / max(ob, 1e-9)) ** 0.5)
        entries.append(PlanEntry(op=op, report=report, op_byte=ob,
                                 est_pim_speedup=est))
    return entries


def render(cfg: ArchConfig, shape: ShapeConfig) -> str:
    rows = [f"PIM offload plan — {cfg.name} x {shape.name}",
            f"{'op':44s} {'op/byte':>8s} {'verdict':>12s} {'est-PIM':>8s}"]
    for e in plan(cfg, shape):
        rows.append(f"{e.op.name[:44]:44s} {e.op_byte:8.2f} "
                    f"{e.report.verdict.value:>12s} "
                    f"{e.est_pim_speedup:7.2f}x")
        rows.append(f"    -> GPU action: {e.op.gpu_action}")
    return "\n".join(rows)
