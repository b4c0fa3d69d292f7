"""Architecture registry of the port: ``get_config("<arch-id>")``.

``base.py`` is a copy of :mod:`repro.configs.base`, and each model file a
copy of its namesake there (the port imports nothing of ``repro``).  The
registry holds the configurations whose every block the port can execute:
decoders with GQA or multi-head latent attention (MLA) and dense or
routed-expert (MoE) feed-forward blocks, the attention-free Mamba-2 stack
(mamba2-370m) and the hybrid of Mamba-2 blocks and one shared attention
block (zamba2-1.2b), the encoder-decoder whisper-tiny (LayerNorm, an
encoder over stub audio frames, cross-attention) and internvl2-26b, whose
stub vision embeddings replace the first positions of its GQA decoder.
"""
from __future__ import annotations

from . import (codeqwen1_5_7b, deepseek_v3_671b, internvl2_26b,
               mamba2_370m, moonshot_v1_16b_a3b, nemotron_4_15b, qwen2_0_5b,
               starcoder2_3b, whisper_tiny, zamba2_1_2b)
from .base import (ArchConfig, AttnKind, BlockKind, Segment,  # noqa: F401
                   SHAPES, ShapeConfig, shapes_for)

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        qwen2_0_5b, moonshot_v1_16b_a3b, starcoder2_3b, nemotron_4_15b,
        codeqwen1_5_7b, deepseek_v3_671b, mamba2_370m, zamba2_1_2b,
        whisper_tiny, internvl2_26b)
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


ALL_ARCHS = tuple(sorted(REGISTRY))
