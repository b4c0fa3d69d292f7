"""DeepSeek-V3-671B [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3].

MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128), 61 layers:
3 dense prefix (d_ff 18432) + 58 MoE (1 shared + 256 routed, top-8,
expert d_ff 2048), MTP auxiliary head, vocab 129280.

This is the cell most representative of the paper's technique: MoE
dispatch *is* a dynamically-sparse skinny GEMM (ss-gemm), and MLA decode is
the compressed-KV memory-bound regime.
"""
from .base import ArchConfig, AttnKind, BlockKind, MlaConfig, MoeConfig, Segment

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, kv_heads=128,
    d_ff=18432, vocab=129_280,
    attn=AttnKind.MLA,
    mla=MlaConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    segments=(Segment(BlockKind.DENSE, 3), Segment(BlockKind.MOE, 58)),
    moe=MoeConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, d_ff_shared=2048,
                  capacity_factor=1.25),
    mtp=True,
    tied_embeddings=False, rope_theta=10_000.0,
)
