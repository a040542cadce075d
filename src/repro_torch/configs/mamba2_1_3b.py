"""mamba2-1.3b: attention-free SSD [arXiv:2405.21060]."""
from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, expand=2),
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=256,
    ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, expand=2, chunk=8),
    remat="none",
)
