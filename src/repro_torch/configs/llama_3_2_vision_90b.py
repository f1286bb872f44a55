"""llama-3.2-vision-90b — dense GQA with cross-attention image layers every
5th layer; vision frontend is a stub supplying patch embeddings
[hf:meta-llama/Llama-3.2-90B-Vision]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    n_image_tokens=1601,
)
