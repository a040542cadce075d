"""TRC101 fire fixture: host syncs on tensors in hot-path functions."""
import numpy as np
import torch


@torch.compile
def hot(x):
    n = int(x)                 # coercion copies the value to the host
    a = np.asarray(x)          # numpy materializes the device tensor
    return x.item() + n + a.sum() + x.cpu().sum()


# replint-torch: traced -- fixture: a hot-path entry point
def step(logits):
    torch.cuda.synchronize()   # waits for the whole card
    return logits.argmax(-1).tolist()
