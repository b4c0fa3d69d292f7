"""Nemotron-4-15B [arXiv:2402.16819].

Dense decoder, GQA (kv=8), squared-ReLU non-gated MLP, huge 256k vocab
(the LM-head/embedding all-gather protagonist of the collective roofline).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    n_layers=32, d_model=6144, n_heads=48, kv_heads=8,
    d_ff=24576, vocab=256_000,
    activation="sq_relu", gated_mlp=False,
    tied_embeddings=False, rope_theta=10_000.0,
    notes="squared-ReLU activation sparsity noted for the PIM planner",
)
