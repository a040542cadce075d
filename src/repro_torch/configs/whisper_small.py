"""whisper-small: enc-dec, conv frontend stubbed (precomputed frame
embeddings) [arXiv:2212.04356]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, enc_len=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, enc_len=32, remat="none",
)
