"""qwen2.5-3b — dense GQA with QKV bias, tied embeddings [hf:Qwen/Qwen2.5]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, head_dim=128,
    qkv_bias=True, tie_embeddings=True,
    block_pattern=("attn",),
)
