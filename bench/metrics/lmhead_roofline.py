"""Kernels: the fused lm-head greedy epilogue's share of its roofline in the
traced slice: the least time of its calls (max_batch x span rows, the
(d, V) head read once, ``bench.roofline``) over the device time of its
kernels (the tensor-core pass and its fold, their spans' union)."""
from bench import roofline

NAMES = ("lmhead_tc_kernel", "lmhead_fold_kernel", "lmhead_partials_kernel")


def read(run):
    if run.trace is None:
        return None
    dev_s = run.trace.family_s(NAMES)
    if dev_s <= 0:
        return None
    calls = sum(s.iters for s in run.traced_steps)
    f, b = roofline.lmhead_cost(run.shape, run.max_batch * run.span)
    return 100.0 * calls * roofline.bound_s(run.shape, f, b) / dev_s
