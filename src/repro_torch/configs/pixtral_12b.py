"""pixtral-12b: pixtral-ViT frontend (stubbed: precomputed patch embeddings)
+ mistral-nemo-style dense backbone [hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, rope_theta=1_000_000.0,
    input_mode="embeddings",
)

SMOKE = ModelConfig(
    name="pixtral-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    input_mode="embeddings", remat="none",
)
