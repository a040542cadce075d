"""Speculation: tokens emitted per live row per mixed iteration over the
window (``ServingEngine.speculation_stats``: above 1 where drafts are
accepted)."""


def read(run):
    d_emit = run.spec1["emitted"] - run.spec0["emitted"]
    d_iter = run.spec1["live_iters"] - run.spec0["live_iters"]
    return d_emit / d_iter if d_iter > 0 else None
