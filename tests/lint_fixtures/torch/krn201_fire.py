"""KRN201 fire fixture: kernel launches with no (or a partial) grad guard."""
import torch

from repro_torch.kernels import refuse_grad


def launch(fn, x, out):
    fn(x.data_ptr(), out.data_ptr(), x.numel(),
       torch.cuda.current_stream(x.device).cuda_stream)
    return out


def launch_partial(fn, x, w, out):
    refuse_grad("kernel", x)             # w is read but never checked
    fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
       torch.cuda.current_stream(x.device).cuda_stream)
    return out
