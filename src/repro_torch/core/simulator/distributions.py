"""Per-class service-demand distributions, calibrated to the paper's testbed.

Paper §IV-A: a tracer on the real IBM Streams sentiment-analysis application showed

  * tweets fall into *classes* = the path taken through the operator graph (Fig 1);
  * per-class processing *delay* on a loaded 1-CPU 2.6 GHz testbed is Weibull
    (NRMSE 0.01 for the off-topic class, Fig 6); tweets discarded by PE(1) have
    (effectively) zero delay;
  * steady state on that testbed: L = 15 875.32 tweets in flight,
    W = 192.09 s mean delay, lambda = 82.65 tweets/s -- consistent with Little's law
    (L = lambda * W = 15 876.24);
  * CPU utilization averaged 97.95%, and "if it is assumed that CPU cycles are
    uniformly distributed to the tweets, there is a reasonable way to convert those
    delay distributions to CPU cycles distributions".

That conversion is what this module implements: with L tweets egalitarian-sharing a
2.6 GHz core at 97.95% utilization, each in-flight tweet receives

  share = FREQ * UTIL / L  =  2.6e9 * 0.9795 / 15875.32  ~=  160.4e3 cycles/s,

so a tweet observed with delay ``d`` seconds demanded ``d * share`` cycles.  The
simulator then runs entirely in the cycles domain, which "allows the extrapolation
of the experiments to other machine configurations" (the simulations use 2.0 GHz
CPUs, Table III).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# --- Testbed constants (paper §IV-A) -------------------------------------------------
TESTBED_FREQ_HZ = 2.6e9
TESTBED_UTILIZATION = 0.9795
TESTBED_IN_FLIGHT = 15_875.32          # L
TESTBED_MEAN_DELAY_S = 192.09          # W
TESTBED_INPUT_RATE = 82.65             # lambda (tweets/s)

#: cycles/second an in-flight tweet received on the testbed (uniform-share assumption)
CYCLES_PER_DELAY_SECOND = TESTBED_FREQ_HZ * TESTBED_UTILIZATION / TESTBED_IN_FLIGHT


@dataclass(frozen=True)
class TweetClass:
    """One path through the operator graph (Fig 1) and its delay model."""

    name: str
    weight: float                  # a-priori proportion of tweets taking this path
    mean_delay_s: float            # mean testbed delay; 0 => the PE(1) discard path
    weibull_shape: float = 1.7

    @property
    def weibull_scale(self) -> float:
        if self.mean_delay_s == 0.0:
            return 0.0
        return self.mean_delay_s / math.gamma(1.0 + 1.0 / self.weibull_shape)

    def delay_quantile(self, q: float) -> float:
        """Inverse CDF of the testbed-delay Weibull (seconds)."""
        if self.mean_delay_s == 0.0:
            return 0.0
        return self.weibull_scale * (-math.log1p(-q)) ** (1.0 / self.weibull_shape)

    def cycles_quantile(self, q: float) -> float:
        return self.delay_quantile(q) * CYCLES_PER_DELAY_SECOND

    def sample_cycles(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.mean_delay_s == 0.0:
            return np.zeros(n, dtype=np.float64)
        d = self.weibull_scale * rng.weibull(self.weibull_shape, size=n)
        return d * CYCLES_PER_DELAY_SECOND


def _calibrated_classes() -> tuple[TweetClass, ...]:
    """Class mixture whose overall mean delay is exactly W = 192.09 s.

    The paper gives the class *structure* (PE(1)-discards ~ zero delay; "most tweets
    are discarded" before full analysis; off-topic is the dominant class) but not the
    exact per-class means, so the non-zero means below are chosen in the observed
    band and then rescaled so the mixture mean matches the published W exactly.
    """
    raw = [
        # name                weight  mean-delay  shape
        ("pe1_discard",        0.10,       0.0,   1.7),   # "delay ... below 1 second"
        ("offtopic_discard",   0.55,     180.0,   1.15),  # Fig 6 class
        ("analyzed_discard",   0.20,     240.0,   1.10),
        ("full_pipeline",      0.15,     300.0,   1.05),
    ]
    # Shapes near 1 give the heavy-ish tails under which the load algorithm's
    # quantile pessimism (~9x the mean at q=99.999%) provides the early-trigger
    # head-room the paper describes; the per-class means/shapes are not published,
    # only the mixture mean (W = 192.09 s) and the Weibull family are.
    mix_mean = sum(w * m for _, w, m, _ in raw)
    scale = TESTBED_MEAN_DELAY_S / mix_mean
    return tuple(
        TweetClass(name, w, m * scale, k) for name, w, m, k in raw
    )


CLASSES: tuple[TweetClass, ...] = _calibrated_classes()


class ServiceModel:
    """A-priori knowledge of the service-demand distributions (used by `load`)."""

    def __init__(self, classes: tuple[TweetClass, ...] = CLASSES):
        if abs(sum(c.weight for c in classes) - 1.0) > 1e-9:
            raise ValueError("class weights must sum to 1")
        self.classes = classes
        self._weights = np.array([c.weight for c in classes])

    # -- used by the trace generator ---------------------------------------------------
    def sample_classes(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(len(self.classes), size=n, p=self._weights).astype(np.int8)

    def sample_cycles(self, rng: np.random.Generator, class_ids: np.ndarray) -> np.ndarray:
        out = np.zeros(class_ids.shape[0], dtype=np.float64)
        for i, c in enumerate(self.classes):
            mask = class_ids == i
            n = int(mask.sum())
            if n:
                out[mask] = c.sample_cycles(rng, n)
        return out

    # -- used by the `load` auto-scaling algorithm -------------------------------------
    def quantile_cycles(self, q: float) -> float:
        """Class-weighted quantile of the service demand, in cycles.

        Paper §IV-C: "The estimated delay is calculated from the quantile function of
        the delay distribution of the different tweet classes and from the proportion
        of the class length.  [...] Each class estimated delay is then weighted
        according to the class length known from the training data."
        """
        return float(sum(c.weight * c.cycles_quantile(q) for c in self.classes))

    def mean_cycles(self) -> float:
        return float(
            sum(c.weight * c.mean_delay_s for c in self.classes) * CYCLES_PER_DELAY_SECOND
        )
