"""whisper-tiny — encoder-decoder; conv frontend is a stub supplying frame
embeddings (input_specs provides them precomputed) [arXiv:2212.04356]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, head_dim=64,
    norm="layernorm", act="gelu",
    encoder_decoder=True, n_encoder_layers=4, encoder_seq=1500,
    block_pattern=("dec",),
)
