"""KRN204 clean twin: a launch failure raises."""
import torch

from repro_torch.kernels import refuse_grad


def launch(fn, x):
    refuse_grad("kernel", x)
    out = torch.empty_like(x)
    try:
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    except OSError as exc:
        raise RuntimeError("kernel launch failed") from exc
    if err:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")
    return out
