"""Mamba2-370m [arXiv:2405.21060; hf:state-spaces/mamba2-370m].

Attention-free SSD stack: 48 Mamba-2 blocks, d_state=128, expand=2,
head_dim=64.  Sub-quadratic: runs the long_500k decode cell.
"""
from .base import ArchConfig, AttnKind, BlockKind, Segment, SsmConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    n_layers=48, d_model=1024, n_heads=16, kv_heads=16,   # unused (attn-free)
    d_ff=0, vocab=50_280,
    attn=AttnKind.NONE,
    segments=(Segment(BlockKind.SSM, 48),),
    ssm=SsmConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tied_embeddings=True,
    sub_quadratic=True,
    notes="paper technique's attention-side optimizations inapplicable "
          "(attention-free); SSD scan is the memory-bound primitive",
)
