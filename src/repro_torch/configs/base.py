"""Architecture + shape configuration schema: the port's copy of
:mod:`repro.configs.base`.

One ``ArchConfig`` per assigned architecture (exact public-literature
numbers live in the per-arch files).  ``reduced()`` produces the same
family at smoke-test scale (tiny widths/depths, same structural features)
for the per-arch CPU tests.  The shape cells (``SHAPES``, ``shapes_for``)
are what the offload planner (:mod:`repro_torch.core.planner`) reads.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence


class AttnKind(enum.Enum):
    GQA = "gqa"
    MLA = "mla"          # deepseek-v3 multi-head latent attention
    NONE = "none"        # attention-free (pure SSM)


class BlockKind(enum.Enum):
    DENSE = "dense"          # attn + dense FFN
    MOE = "moe"              # attn + routed-experts FFN
    SSM = "ssm"              # mamba2 SSD block
    SHARED_ATTN = "shared"   # zamba2-style shared transformer block


class Frontend(enum.Enum):
    NONE = "none"
    VISION_STUB = "vision"   # precomputed patch embeddings (VLM)
    AUDIO_STUB = "audio"     # precomputed frame embeddings (enc-dec audio)


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0               # shared-expert hidden size
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    # "softmax" (softmax top-k, renormalised) or "noaux_tc" (DeepSeek-V3:
    # sigmoid scores plus a correction bias pick the experts within the
    # ``topk_group`` best of ``n_group`` groups; the weights are the
    # picked sigmoid scores renormalised times ``routed_scaling``)
    router: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    routed_scaling: float = 1.0
    # the experts this chip holds, 0 .. experts_held - 1 of n_experts (the
    # expert-parallel share of one chip); 0 holds them all
    experts_held: int = 0


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # YaRN over the rope dims (DeepSeek-V3's rope_scaling, whose mscale
    # equals its mscale_all_dim, so the rope tables keep their unit
    # gain); factor 1 is plain RoPE
    yarn_factor: float = 1.0
    yarn_original_len: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of identical layers, scanned as one unit."""

    kind: BlockKind
    count: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    # structure
    segments: tuple[Segment, ...] = ()
    attn: AttnKind = AttnKind.GQA
    activation: str = "silu"           # silu|gelu|sq_relu
    gated_mlp: bool = True
    qkv_bias: bool = False
    tied_embeddings: bool = False
    head_dim: int | None = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # family extensions
    moe: MoeConfig | None = None
    mla: MlaConfig | None = None
    ssm: SsmConfig | None = None
    shared_attn_every: int = 0         # zamba2: shared block period
    mtp: bool = False                  # deepseek multi-token prediction
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500            # audio frames after the conv stub
    frontend: Frontend = Frontend.NONE
    vision_tokens: int = 0             # VLM stub: prefix length
    sub_quadratic: bool = False        # eligible for long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def resolved_segments(self) -> tuple[Segment, ...]:
        if self.segments:
            return self.segments
        return (Segment(BlockKind.DENSE, self.n_layers),)

    def reduced(self) -> "ArchConfig":
        """Smoke-test-scale config of the same family."""
        segs = tuple(Segment(s.kind, min(s.count, 2))
                     for s in self.resolved_segments()[:4])
        moe = None
        if self.moe:
            # capacity_factor high enough that nothing drops at smoke scale,
            # so cached decode exactly matches the full forward; groups of
            # two experts and a partial share kept where the model has them
            m = self.moe
            n = min(8, m.n_experts)
            groups = min(m.n_group, max(1, n // 2))
            moe = dataclasses.replace(
                m, n_experts=n, top_k=min(2, m.top_k), d_ff_expert=64,
                d_ff_shared=64 if m.n_shared_experts else 0,
                capacity_factor=8.0, n_group=groups,
                topk_group=max(1, m.topk_group * groups // m.n_group),
                experts_held=(min(m.experts_held, n // 2)
                              if 0 < m.experts_held < m.n_experts else 0))
        mla = dataclasses.replace(
            self.mla, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=8, v_head_dim=8) if self.mla else None
        ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=8,
                                  chunk=8) if self.ssm else None
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            n_layers=sum(s.count for s in segs), d_model=64,
            n_heads=4, kv_heads=min(4, max(1, self.kv_heads * 4
                                           // max(1, self.n_heads))),
            d_ff=128, vocab=256, head_dim=16, segments=segs, moe=moe,
            mla=mla, ssm=ssm,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_encoder_layers=min(2, self.n_encoder_layers),
            encoder_seq=16 if self.enc_dec else self.encoder_seq,
            vision_tokens=8 if self.vision_tokens else 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(arch: ArchConfig) -> Sequence[ShapeConfig]:
    """The assignment's shape set for an arch (long_500k only for
    sub-quadratic families; all archs here have decoders)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.sub_quadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]
