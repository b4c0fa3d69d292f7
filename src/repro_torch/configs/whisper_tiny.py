"""Whisper-tiny [arXiv:2212.04356].

Encoder-decoder, 4+4 layers, d=384, 6 heads, LayerNorm + GELU (non-gated).
Conv frontend is a STUB: the encoder consumes precomputed frame embeddings
(1500 frames = 30 s at 50 Hz after the stride-2 conv stem).
Deviation from the paper: the decoder uses RoPE instead of learned
absolute positions (structure-preserving on TPU).
"""
from .base import ArchConfig, Frontend

CONFIG = ArchConfig(
    name="whisper-tiny",
    n_layers=4, d_model=384, n_heads=6, kv_heads=6,
    d_ff=1536, vocab=51_865,
    activation="gelu", gated_mlp=False,
    tied_embeddings=True,
    enc_dec=True, n_encoder_layers=4, encoder_seq=1500,
    frontend=Frontend.AUDIO_STUB,
)
