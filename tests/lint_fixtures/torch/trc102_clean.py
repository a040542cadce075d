"""TRC102 clean twin: host branches and device-side selects."""
import torch


def step(x, live, scale: float = 2.0, extra=None):
    if scale > 1.0:                        # a config knob: host Python
        x = x * scale
    if x.shape[0] > 1:                     # shapes are host metadata
        x = x + 1
    if extra is None:                      # identity tests never sync
        extra = torch.zeros_like(x)
    for t in (x, extra):                   # a tuple of tensors: a host container
        t.add_(0)
    return torch.where(live[:, None], x, -x) + extra


def capture(x, live):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = step(x, live)
    return g, y
