"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427 (Griffin)].  26 layers = 8 x (rglru, rglru, local) + 2."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    window=2048, d_rnn=2560, conv_width=4,
)
