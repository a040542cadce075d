from repro_torch.checkpoint.store import F32_LEAVES, load_jax_npz, params_from_jax

__all__ = ["F32_LEAVES", "load_jax_npz", "params_from_jax"]
