"""InternVL2-26B [arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B].

InternViT-6B vision frontend (STUB: precomputed patch embeddings per the
assignment) + InternLM2-20B language backbone: 48L, GQA kv=8, gated SiLU.
"""
from .base import ArchConfig, Frontend

CONFIG = ArchConfig(
    name="internvl2-26b",
    n_layers=48, d_model=6144, n_heads=48, kv_heads=8,
    d_ff=16384, vocab=92_553,
    activation="silu", gated_mlp=True,
    tied_embeddings=False, rope_theta=1_000_000.0,
    frontend=Frontend.VISION_STUB, vision_tokens=256,
    notes="vision tokens = 256 precomputed patch embeddings (one 448px "
          "tile after pixel-shuffle); backbone only per assignment",
)
