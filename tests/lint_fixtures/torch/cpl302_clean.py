"""CPL302 clean twin: convert with multiply/divide before combining."""


def budget(window_s, step_s, cost_rate):
    horizon_steps = round(window_s / step_s)   # divide converts s -> steps
    covered_s = horizon_steps * step_s         # multiply converts back
    cost = window_s / 3600.0 * cost_rate       # s -> hours via divide
    return horizon_steps, covered_s + step_s, cost
