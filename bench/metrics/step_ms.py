"""Engine: mean host-clock time of one ``ServingEngine.step`` call over the
steps that started in the window (each ends in the engine's sync)."""


def read(run):
    steps = run.window_steps
    return sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3 if steps else None
