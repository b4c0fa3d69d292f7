"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B].

Qwen1.5 architecture: full MHA (kv=32 == heads), QKV bias, gated SiLU.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    n_layers=32, d_model=4096, n_heads=32, kv_heads=32,
    d_ff=13440, vocab=92_416,
    activation="silu", gated_mlp=True, qkv_bias=True,
    tied_embeddings=False, rope_theta=1_000_000.0,
)
