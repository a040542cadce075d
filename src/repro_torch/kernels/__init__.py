"""Hand-written CUDA kernels for Hopper (``csrc/``), built at first use by
:mod:`repro_torch.kernels.build`, each beside its plain PyTorch version.

No kernel has a backward, as no Pallas kernel of the JAX package has one
(its training path never reaches them).  A wrapper that would launch its
kernel on tensors that autograd tracks raises :func:`refuse_grad`'s error
instead of returning an output with no gradient.
"""
import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd is on and any of ``tensors`` (None skipped)
    requires a gradient: the CUDA kernel's output would carry none, and its
    inputs would silently get zero gradients."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            "train through the plain route (Model.loss_fn runs forward(..., "
            "use_kernel=False)) or call the kernel under torch.no_grad()")
