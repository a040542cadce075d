"""olmoe-1b-7b: 64-expert top-8 MoE, MHA kv=16 [arXiv:2409.02060]."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=4.0), remat="none",
)
