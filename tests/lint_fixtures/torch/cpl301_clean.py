"""CPL301 clean twin: 'now' is a parameter, RNG is explicitly seeded."""
import numpy as np


def decide(observation, now: float, seed: int):
    rng = np.random.default_rng(seed)
    return now + rng.random()
