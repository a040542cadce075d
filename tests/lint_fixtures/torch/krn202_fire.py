"""KRN202 fire fixture: one tensor's pointer twice in one launch."""
import torch

from repro_torch.kernels import refuse_grad


def launch(fn, x):
    refuse_grad("kernel", x)
    fn(x.data_ptr(), x.data_ptr(), x.numel(),       # input and output alias
       torch.cuda.current_stream(x.device).cuda_stream)
    return x
