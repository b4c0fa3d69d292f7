"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B] ("moonshot-v1-16b-a3b").

DeepSeek-MoE-style: 48 layers (1 dense prefix + 47 MoE), 64 routed experts
top-6 + 2 shared, expert d_ff 1408, GQA kv=16, vocab 163840.
"""
from .base import ArchConfig, BlockKind, MoeConfig, Segment

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, kv_heads=16,
    d_ff=11264, vocab=163_840,
    segments=(Segment(BlockKind.DENSE, 1), Segment(BlockKind.MOE, 47)),
    moe=MoeConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, d_ff_shared=2816,
                  capacity_factor=1.25),
    tied_embeddings=False, rope_theta=50_000.0,
)
