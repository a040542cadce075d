"""TRC102 fire fixture: Python control flow on tensors in a captured body."""
import torch


def step(x, live):
    if live.any():             # implicit bool(): a host sync
        x = x + 1
    return x if x.sum() > 0 else -x


def capture(x, live):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = step(x, live)
        while (x < 0).any():   # the captured region itself branches on a tensor
            x = x + 1
    return g, y
