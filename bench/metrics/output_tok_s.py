"""Every output token emitted in the window over the window's seconds (its
last step ends the window)."""


def read(run):
    steps = run.window_steps
    return sum(s.emitted for s in steps) / run.close if steps and run.close > 0 else None
