"""Small statistics helpers shared by the simulator and the analysis benchmarks."""
from __future__ import annotations

import math

import numpy as np


def pearson(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson correlation coefficient (nan-safe)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.size < 2 or y.size < 2:
        return float("nan")
    xc = x - x.mean()
    yc = y - y.mean()
    denom = math.sqrt(float(xc @ xc) * float(yc @ yc))
    if denom == 0.0:
        return float("nan")
    return float(xc @ yc) / denom


# Two-sided 97.5% normal quantile; the paper runs scenarios "until the length of the
# confidence interval with 95% confidence was smaller than 10% of the mean".
_Z975 = 1.959963984540054


def mean_confidence_interval(samples) -> tuple[float, float]:
    """Return (mean, full CI length) of the 95% normal-approx confidence interval."""
    a = np.asarray(samples, dtype=np.float64)
    if a.size == 0:
        return float("nan"), float("inf")
    m = float(a.mean())
    if a.size == 1:
        return m, float("inf")
    se = float(a.std(ddof=1)) / math.sqrt(a.size)
    return m, 2.0 * _Z975 * se


def ci_converged(samples, rel: float = 0.10) -> bool:
    """Paper's stopping rule: CI length < ``rel`` x mean (needs >= 2 samples)."""
    a = np.asarray(samples, dtype=np.float64)
    if a.size < 2:
        return False
    m, length = mean_confidence_interval(a)
    if m == 0.0:
        # Degenerate (e.g. zero violations in every repetition): converged.
        return float(a.std(ddof=1)) == 0.0
    return length < rel * abs(m)
