"""TRC101 clean twin: metadata coercions and host-side syncs are fine."""
import torch


@torch.compile
def hot(x, scale: float = 2.0):
    n = int(x.shape[0])        # shapes are host Python
    m = int(x.numel())         # so is the element count
    y = torch.as_tensor(x)     # a device-side view, no sync
    return y * n * m * scale


def host(x):
    return float(x)            # not reachable: host code may sync
