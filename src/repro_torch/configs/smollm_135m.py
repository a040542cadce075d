"""smollm-135m: llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49152,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke", family="dense",
    n_layers=3, d_model=48, n_heads=3, n_kv_heads=3, d_ff=96, vocab=256,
    tie_embeddings=True, remat="none",
)
