"""deepseek-moe-16b — fine-grained MoE: 64 routed top-6 + 2 shared experts
[arXiv:2401.06066; hf].  Deviation (DESIGN.md): HF layer 0 is dense; we use
MoE on every layer for a uniform scan (<2% parameter delta)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10_000.0,
    moe_num_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_num_shared=2,
    moe_every=1,
    moe_norm_topk=False,  # deepseek v1 does not renormalize top-k gates
)
