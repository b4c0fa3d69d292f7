"""StarCoder2-3B [arXiv:2402.19173; hf:bigcode/starcoder2-3b].

Dense decoder, GQA (kv=2), RoPE, non-gated GELU MLP, tied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    n_layers=30, d_model=3072, n_heads=24, kv_heads=2,
    d_ff=12288, vocab=49152,
    activation="gelu", gated_mlp=False, qkv_bias=True,
    tied_embeddings=True, rope_theta=100_000.0,
    notes="GQA kv=2; bias on projections per hf config",
)
