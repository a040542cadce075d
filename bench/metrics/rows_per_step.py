"""Engine: mean rows served by a step in the window (``step``'s return:
rows of the device loop plus completions at fill time)."""


def read(run):
    steps = run.window_steps
    return sum(s.served for s in steps) / len(steps) if steps else None
