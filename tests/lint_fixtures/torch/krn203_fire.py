"""KRN203 fire fixture: launches on the legacy stream."""
import torch

from repro_torch.kernels import refuse_grad


def launch(fn, x):
    refuse_grad("kernel", x)
    out = torch.empty_like(x)
    fn(x.data_ptr(), out.data_ptr(), x.numel(), 0)       # stream 0: legacy
    fn(x.data_ptr(), out.data_ptr(), x.numel(), None)    # so is None
    return out
