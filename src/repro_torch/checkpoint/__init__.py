from repro_torch.checkpoint.store import load_jax_npz, params_from_jax

__all__ = ["load_jax_npz", "params_from_jax"]
