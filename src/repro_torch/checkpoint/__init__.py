from repro_torch.checkpoint.store import (
    F32_LEAVES,
    OK_SUFFIX,
    CheckpointManager,
    load_checkpoint,
    load_jax_npz,
    params_from_jax,
    save_checkpoint,
)

__all__ = ["F32_LEAVES", "OK_SUFFIX", "CheckpointManager", "load_checkpoint",
           "load_jax_npz", "params_from_jax", "save_checkpoint"]
