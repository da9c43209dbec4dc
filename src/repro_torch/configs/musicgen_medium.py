"""musicgen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf].  Backbone only: the EnCodec frontend is a stub and
the 4 codebook streams are folded to a single token stream (DESIGN.md)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=10_000.0,
    frontend="audio_stub",
)
