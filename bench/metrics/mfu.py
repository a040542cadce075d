"""Model step: useful operations of the window over the window's seconds,
as a share of the card's peak for the served type (bf16: 989 TFLOP/s).  Useful: 2 per weight for each position
whose key and value the window committed (prompt tokens and accepted
tokens; rejected drafts, padding rows and the MoE layer's padded expert
slots are not counted), the lm-head at every such position, and the
attention scores and weighted values at each position's context
(``bench.roofline``)."""
from bench import roofline


def read(run):
    steps = run.window_steps
    if not steps or run.close <= 0:
        return None
    flops = sum(roofline.positions_flops(run.shape, a, b) for s in steps for a, b in s.rows)
    return 100.0 * flops / (run.close * run.shape.peak)
