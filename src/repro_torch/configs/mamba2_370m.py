"""mamba2-370m — pure SSM (SSD, state-space duality) [arXiv:2405.21060]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,       # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,            # mamba blocks subsume the MLP; see layer_pattern
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    layer_pattern=("ssm",),
)
