"""paligemma-3b — SigLIP + gemma VLM; the vision tower is a STUB per the
assignment: input_specs() supplies precomputed patch embeddings
[arXiv:2407.07726; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,    # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    rope_theta=10_000.0,
    frontend="vlm_stub",
    num_prefix_embeddings=256,  # 224px / 14 patch -> 16x16
)
