"""minicpm3-4b — dense with multi-head latent attention (MLA)
[hf:openbmb/MiniCPM3-4B; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,   # MLA: per-head latents; kv=40 per assignment table
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    rope_theta=10_000.0,
)
