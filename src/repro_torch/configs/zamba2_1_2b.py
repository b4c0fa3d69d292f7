"""Zamba2-1.2B [arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B].

Hybrid: Mamba-2 backbone (d_state=64) with a *shared* transformer block
(GQA kv=32, d_ff=8192) re-applied every ~6 layers (weights shared across
occurrences, as in the paper).  Sub-quadratic: runs long_500k.
Simplifications, as in the JAX package's config: one shared block (Zamba2 alternates two)
and no LoRA projectors on the shared block.
"""
from .base import ArchConfig, BlockKind, Segment, SsmConfig

_PATTERN = (
    Segment(BlockKind.SSM, 6), Segment(BlockKind.SHARED_ATTN, 1),
    Segment(BlockKind.SSM, 6), Segment(BlockKind.SHARED_ATTN, 1),
    Segment(BlockKind.SSM, 6), Segment(BlockKind.SHARED_ATTN, 1),
    Segment(BlockKind.SSM, 6), Segment(BlockKind.SHARED_ATTN, 1),
    Segment(BlockKind.SSM, 6), Segment(BlockKind.SHARED_ATTN, 1),
    Segment(BlockKind.SSM, 3),
)

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    n_layers=38, d_model=2048, n_heads=32, kv_heads=32,
    d_ff=8192, vocab=32_000,
    segments=_PATTERN,
    ssm=SsmConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    shared_attn_every=6,
    tied_embeddings=True,
    sub_quadratic=True,
)
