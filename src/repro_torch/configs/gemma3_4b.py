"""gemma3-4b: 5:1 local(1024-SWA):global interleave, 128k context, 256k vocab
[hf:google/gemma-3-4b-pt]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab=262144, head_dim=256, window=1024, global_every=6,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, window=8, global_every=3, remat="none",
)
