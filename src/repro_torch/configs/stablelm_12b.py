"""stablelm-12b — dense GQA [hf:stabilityai/stablelm-2-12b family]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352, head_dim=160,
    block_pattern=("attn",),
)
