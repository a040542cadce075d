"""Hand-written CUDA kernels for Hopper (``csrc/``), built at first use by
:mod:`repro_torch.kernels.build`, each beside its plain PyTorch version."""
