"""CPL302 fire fixture: additive arithmetic across unit families."""


def budget(window_s, horizon_steps, price_unit_hours):
    total_s = window_s + horizon_steps        # seconds + steps
    if window_s > price_unit_hours:           # seconds vs hours compare
        total_s = total_s - horizon_steps     # seconds - steps
    return total_s
