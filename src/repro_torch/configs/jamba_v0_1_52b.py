"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with 16-expert
top-2 MoE every other layer [arXiv:2403.19887; hf].  Deviation (DESIGN.md):
SSM layers use the Mamba2/SSD block (TPU-friendly chunked matmul form)
rather than Mamba1's selective scan."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=10_000.0,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    # 1 attention layer per 8 (1:7 ratio), attention at slot 4 as in the paper
    layer_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
)
