"""smollm-360m: llama-arch small [hf:HuggingFaceTB/SmolLM-360M]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560, vocab=49152,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=3, d_model=48, n_heads=3, n_kv_heads=1, d_ff=128, vocab=256,
    tie_embeddings=True, remat="none",
)
