"""zamba2-2.7b: 54L Mamba2 stack + ONE shared attention(+MLP) block applied
every 6th layer [arXiv:2411.15242]."""
from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, ssm=SSMConfig(d_state=64, head_dim=64, n_groups=1, expand=2),
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, expand=2, chunk=8),
    shared_attn_every=3, remat="none",
)
