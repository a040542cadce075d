"""KRN203 clean twin: the stream comes from torch.cuda.current_stream."""
import torch

from repro_torch.kernels import refuse_grad


def launch(fn, x):
    refuse_grad("kernel", x)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device)
    fn(x.data_ptr(), out.data_ptr(), x.numel(), stream.cuda_stream)
    return out
