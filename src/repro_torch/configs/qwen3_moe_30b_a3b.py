"""qwen3-moe-30b-a3b — 128-expert top-8 MoE, GQA, qk-norm
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,          # unused (all layers MoE); kept for table fidelity
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe_num_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
    moe_every=1,
    moe_norm_topk=True,
)
