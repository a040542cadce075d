"""KRN204 fire fixture: a fallback that hides a failed launch."""
import torch

from repro_torch.kernels import refuse_grad


def launch(fn, plain, x):
    refuse_grad("kernel", x)
    out = torch.empty_like(x)
    try:
        fn(x.data_ptr(), out.data_ptr(), x.numel(),
           torch.cuda.current_stream(x.device).cuda_stream)
    except Exception:
        out = plain(x)                   # silently computes something else
    return out
