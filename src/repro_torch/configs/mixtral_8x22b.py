"""mixtral-8x22b: 8-expert top-2 MoE, SWA 4096 [arXiv:2401.04088]."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=256,
    window=16, moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, capacity_factor=4.0), remat="none",
)
