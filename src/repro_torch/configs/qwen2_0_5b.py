"""Qwen2-0.5B [arXiv:2407.10671; hf:Qwen/Qwen2-0.5B].

Dense decoder, GQA (kv=2), QKV bias, gated SiLU, tied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    n_layers=24, d_model=896, n_heads=14, kv_heads=2,
    d_ff=4864, vocab=151_936,
    activation="silu", gated_mlp=True, qkv_bias=True,
    tied_embeddings=True, rope_theta=1_000_000.0,
)
