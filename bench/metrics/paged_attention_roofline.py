"""Kernels: the paged mixed attention's share of its roofline in the traced
slice: the least time its calls need (``bench.roofline``: each row's keys
and values read once, at the positions its queries see) over the device
time of its kernels (first pass and merge, their spans' union).  Rows
that joined in a step count from 0; within a step of several iterations a
row's start is taken on the line from its committed count before the
step to after it."""
from bench import roofline

NAMES = ("paged_mixed_split_kernel", "paged_split_merge_kernel",
         "paged_mixed_attention_kernel")


def read(run):
    if run.trace is None:
        return None
    dev_s = run.trace.family_s(NAMES)
    if dev_s <= 0:
        return None
    need = 0.0
    for s in run.traced_steps:
        for j in range(s.iters):
            starts = [a + (b - a) * j / s.iters for a, b in s.rows]
            starts += [0] * (run.max_batch - len(starts))
            f, b = roofline.paged_attention_cost(run.shape, starts, run.span, run.page_size)
            need += run.shape.layers * roofline.bound_s(run.shape, f, b)
    return 100.0 * need / dev_s
