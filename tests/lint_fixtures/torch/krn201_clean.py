"""KRN201 clean twin: every input checked before the launch."""
import torch

from repro_torch.kernels import refuse_grad


def launch(fn, x, w):
    refuse_grad("kernel", x, w)
    out = torch.empty_like(x)            # made here: needs no check
    fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
       torch.cuda.current_stream(x.device).cuda_stream)
    return out
