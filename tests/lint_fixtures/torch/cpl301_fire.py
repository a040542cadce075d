"""CPL301 fire fixture: wall-clock and ambient RNG in decision code."""
import time

import numpy as np


def decide(observation):
    now = time.monotonic()           # wall-clock read
    jitter = np.random.random()      # global (unseeded) RNG
    rng = np.random.default_rng()    # constructor without a seed
    return now + jitter + rng.random()
