"""Three-term roofline from the port's dry-run records, from
:mod:`repro.roofline.analysis`.

Per (arch x shape x mesh) cell, from the trace analyzer's per-device
stats (:mod:`repro_torch.roofline.trace_analyzer`, in place of the HLO
analyzer's):

  compute term    = trace FLOPs / peak FLOP/s          (per device)
  memory term     = bytes / HBM bandwidth              (per device)
  collective term = collective bytes / NVLink bandwidth

The device is the H100 of :class:`repro_torch.core.hwspec.HopperSpec` in
place of JAX's TPU v5e: 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s of
NVLink a direction.  The collective term is a lower bound: it assumes
NVLink between every pair of ranks.  Every term is a spec-sheet bound on
host arithmetic, not a measurement.  The bytes are JAX's estimate: one
bf16 pass over the per-device parameters, bounded below by the record's
``bytes_accessed`` and by the dots' traffic at a 512-tile intensity.

MODEL_FLOPS = 6 * N_active * tokens for training cells (2x for
inference), plus the attention scores: the "useful work" yardstick;
MODEL_FLOPS / trace FLOPs exposes remat and redundancy.  The parameter
and FLOP counts are config arithmetic, copied.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from ..configs import get_config
from ..configs.base import SHAPES, ArchConfig, BlockKind
from ..core.hwspec import DEFAULT_HOPPER, HopperSpec


# ---------------------------------------------------------------------------
# analytical parameter / flops model
# ---------------------------------------------------------------------------

def param_counts(cfg: ArchConfig) -> dict[str, float]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    counts: dict[str, float] = {}
    counts["embed"] = cfg.vocab * d
    if not cfg.tied_embeddings:
        counts["lm_head"] = cfg.vocab * d
    attn = 0.0
    dense_ffn = 0.0
    moe_ffn = 0.0
    shared_ffn = 0.0
    ssm = 0.0
    n_attn = n_dense = n_moe = n_ssm = n_shared = 0
    for seg in cfg.resolved_segments():
        if seg.kind is BlockKind.SSM:
            n_ssm += seg.count
        elif seg.kind is BlockKind.MOE:
            n_moe += seg.count
            n_attn += seg.count
        elif seg.kind is BlockKind.SHARED_ATTN:
            n_shared += 1
        else:
            n_dense += seg.count
            n_attn += seg.count
    if cfg.mla:
        m = cfg.mla
        per_attn = (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads
                    * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * m.kv_lora_rank + d * m.qk_rope_head_dim
                    + m.kv_lora_rank * cfg.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + cfg.n_heads * m.v_head_dim * d)
    else:
        per_attn = d * hd * (cfg.n_heads + 2 * cfg.kv_heads) \
            + cfg.n_heads * hd * d
    attn = per_attn * n_attn
    mlp_mult = 3 if cfg.gated_mlp else 2
    dense_ffn = n_dense * mlp_mult * d * cfg.d_ff
    if cfg.moe:
        m = cfg.moe
        moe_ffn = n_moe * (m.n_experts * 3 * d * m.d_ff_expert
                           + d * m.n_experts)
        if m.n_shared_experts:
            sf = m.d_ff_shared or m.d_ff_expert * m.n_shared_experts
            moe_ffn += n_moe * 3 * d * sf
    if cfg.ssm:
        s = cfg.ssm
        d_inner = s.expand * d
        h = d_inner // s.head_dim
        d_xbc = d_inner + 2 * s.n_groups * s.d_state
        ssm = n_ssm * (d * d_inner + d * d_xbc + d * h
                       + s.d_conv * d_xbc + d_inner * d)
    if n_shared:
        shared_ffn = per_attn + mlp_mult * d * cfg.d_ff   # one shared copy
    encoder = 0.0
    if cfg.enc_dec:
        # encoder blocks (full-head self-attn + MLP) + per-decoder-layer
        # cross-attention projections
        enc_attn = d * hd * cfg.n_heads * 4
        encoder = cfg.n_encoder_layers * (enc_attn + mlp_mult * d * cfg.d_ff)
        encoder += 2 * d * cfg.kv_heads * hd          # cross K/V projections
        attn += n_attn * 2 * d * hd * cfg.kv_heads    # cross-attn per block
    counts.update(attn=attn, dense_ffn=dense_ffn, moe_ffn=moe_ffn,
                  ssm=ssm, shared=shared_ffn, encoder=encoder)
    return counts


def n_params(cfg: ArchConfig) -> float:
    return sum(param_counts(cfg).values())


def n_active_params(cfg: ArchConfig) -> float:
    """Per-token active parameters (MoE: top_k + shared experts only)."""
    counts = param_counts(cfg)
    total = sum(v for k, v in counts.items() if k != "moe_ffn")
    if cfg.moe:
        m = cfg.moe
        n_moe = sum(s.count for s in cfg.resolved_segments()
                    if s.kind is BlockKind.MOE)
        d = cfg.d_model
        active = n_moe * (m.top_k * 3 * d * m.d_ff_expert + d * m.n_experts)
        if m.n_shared_experts:
            sf = m.d_ff_shared or m.d_ff_expert * m.n_shared_experts
            active += n_moe * 3 * d * sf
        total += active
    # shared attention blocks execute once per occurrence
    n_shared_sites = sum(1 for s in cfg.resolved_segments()
                         if s.kind is BlockKind.SHARED_ATTN)
    if n_shared_sites > 1:
        total += counts["shared"] * (n_shared_sites - 1)
    return total


def model_flops(cfg: ArchConfig, shape_name: str) -> float:
    """6·N_active·tokens for train, 2·N_active·tokens for inference, plus
    dense attention score flops where applicable (global, all devices)."""
    shape = SHAPES[shape_name]
    mult = 6.0 if shape.kind == "train" else 2.0
    if shape.kind == "decode":
        tokens = shape.global_batch * 1
    else:
        tokens = shape.global_batch * shape.seq_len
    base = mult * n_active_params(cfg) * tokens
    # attention scores (dense archs): 2 * 2 * T * L_ctx * d_attn per layer
    n_attn = sum(s.count for s in cfg.resolved_segments()
                 if s.kind in (BlockKind.DENSE, BlockKind.MOE)) \
        + sum(1 for s in cfg.resolved_segments()
              if s.kind is BlockKind.SHARED_ATTN)
    if n_attn and cfg.attn.value != "none":
        hd = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
              if cfg.mla else cfg.resolved_head_dim)
        heads = cfg.n_heads
        if shape.kind == "decode":
            ctx = shape.seq_len
            per_tok = 2 * 2 * ctx * heads * hd
        else:
            ctx = shape.seq_len / 2          # causal average
            per_tok = 2 * 2 * ctx * heads * hd * (3 if shape.kind == "train"
                                                  else 1)
        base += n_attn * tokens * per_tok
    return base


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    compute_ns: float
    memory_ns: float
    collective_ns: float
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    model_flops_total: float
    useful_ratio: float
    peak_flops_per_ns: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_ns, "memory": self.memory_ns,
                 "collective": self.collective_ns}
        return max(terms, key=terms.get)

    @property
    def roofline_frac(self) -> float:
        """Fraction of the step spent at the *compute* roofline if the
        dominant term were the only one (useful-compute / bound-time)."""
        useful_ns = (self.model_flops_total / self.n_devices
                     / self.peak_flops_per_ns)
        bound = max(self.compute_ns, self.memory_ns, self.collective_ns)
        return useful_ns / bound if bound else 0.0

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},"
                f"{self.compute_ns / 1e6:.3f},{self.memory_ns / 1e6:.3f},"
                f"{self.collective_ns / 1e6:.3f},{self.bound},"
                f"{self.useful_ratio:.2f},{self.roofline_frac:.3f}")


def from_artifact(path: pathlib.Path, cfg: ArchConfig | None = None,
                  spec: HopperSpec = DEFAULT_HOPPER) -> Roofline:
    """The cell's roofline from its dry-run record; ``spec`` the device's
    peaks (the H100's by default)."""
    rec = json.loads(pathlib.Path(path).read_text())
    arch, shape, mesh = rec["arch"], rec["shape"], rec["mesh"]
    cfg = cfg or get_config(arch)
    n_dev = rec["n_devices"]
    ts = rec.get("trace_stats", {}) or {}
    flops_dev = float(ts.get("flops") or rec.get("flops") or 0.0)
    coll = ts.get("collective_bytes") or rec.get("collective_bytes") or {}
    coll_bytes = float(sum(coll.values()))
    # memory bytes: params touched once + dot traffic estimate; lower-bound
    # by the record's bytes_accessed
    param_bytes_dev = n_params(cfg) * 2.0 / n_dev      # bf16 resident pass
    raw_bytes = float(rec.get("bytes_accessed") or 0.0)
    # dots stream operands from HBM at worst; assume operands ~ flops/(2*512)
    # (arithmetic intensity of a 512-tile matmul) as the HBM-traffic proxy.
    dot_bytes = flops_dev / (2.0 * 512.0) * 2.0
    mem_bytes_dev = max(param_bytes_dev, raw_bytes, dot_bytes)
    mflops = model_flops(cfg, shape)
    peak = spec.peak_flops_per_ns("bfloat16")
    compute_ns = flops_dev / peak
    memory_ns = mem_bytes_dev / spec.hbm_gbps
    coll_ns = coll_bytes / spec.nvlink_gbps
    useful = mflops / (flops_dev * n_dev) if flops_dev else 0.0
    return Roofline(arch=arch, shape=shape, mesh=mesh, n_devices=n_dev,
                    compute_ns=compute_ns, memory_ns=memory_ns,
                    collective_ns=coll_ns, flops_dev=flops_dev,
                    bytes_dev=mem_bytes_dev, coll_bytes_dev=coll_bytes,
                    model_flops_total=mflops, useful_ratio=useful,
                    peak_flops_per_ns=peak)
