"""The one traffic generator: a mix file's parameters and a seed in, the
requests of one window out.

Every seed gets the same set of sizes and the same set of gaps between
arrivals, in another order: the lengths are the quantiles ``(i + 0.5) / N``
of the mix's distributions and the gaps those of the unit exponential,
each permuted by the seed.  So two seeds offer the same work and differ in
which request comes when and in their token ids, and the spread between
runs is the system's, not the draw's.

Arrivals are a Poisson process in the time that the cumulative rate
``Lambda(t)`` measures (time rescaling): a steady rate maps it linearly, a
burst through the profile below.  ``kind: backlog`` queues every request
at t = 0, ``backlog_per_s`` of them for each second of the window.

Frozen copy: :func:`burst_profile` is ``_burst_profile`` of
``repro_torch/core/simulator/workload.py`` (the paper's Fig. 4 burst: a
Gaussian leading edge, then an exponential decay) with its random rise and
decay replaced by the mix's fixed ``rise_s`` and ``decay_s``; the Poisson
arithmetic follows that module's ``generate_trace`` (arrivals from the
integrated rate).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass(frozen=True)
class Arrival:
    rid: int
    due_s: float            # seconds after the window opens
    prompt: np.ndarray      # int32 token ids
    max_new_tokens: int


def burst_profile(t: np.ndarray, onset: float, scale: float, rise: float,
                  decay: float) -> np.ndarray:
    """Multiplicative burst: 1 far before ``onset``, ``scale`` at it, a
    Gaussian leading edge of width ``rise`` and an exponential decay of time
    constant ``decay`` after it."""
    prof = np.where(t < onset,
                    np.exp(-((t - onset) ** 2) / (2.0 * rise ** 2)),
                    np.exp(-(t - onset) / decay))
    return 1.0 + (scale - 1.0) * prof


def _rate(arr: dict, base_rate: float, t: np.ndarray) -> np.ndarray:
    if arr["kind"] == "poisson":
        return np.full_like(t, base_rate)
    if arr["kind"] == "burst":
        return base_rate * burst_profile(t, arr["onset_s"], arr["scale"],
                                         arr["rise_s"], arr["decay_s"])
    raise ValueError(f"unknown arrival kind {arr['kind']!r}")


def arrival_times(arr: dict, base_rate: float, seconds: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Due times in [0, seconds): N = round(Lambda(seconds)) arrivals, the
    unit-exponential quantile gaps permuted by ``rng``, mapped through the
    inverse of the cumulative rate."""
    grid = np.linspace(0.0, seconds, 4001)
    lam = _rate(arr, base_rate, grid)
    cum = np.concatenate([[0.0], np.cumsum((lam[1:] + lam[:-1]) * 0.5 * np.diff(grid))])
    n = int(round(cum[-1]))
    if n == 0:
        return np.zeros(0)
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n))
    unit = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * cum[-1] / gaps.sum()
    return np.interp(unit, cum, grid)


def lengths(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The quantiles (i + 0.5) / n of ``dist``, clipped to [min, max] and
    permuted by ``rng``."""
    p = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["kind"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in p])
        v = np.round(dist["median"] * np.exp(dist["sigma"] * z))
    elif dist["kind"] == "uniform":
        v = lo + np.floor(p * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {dist['kind']!r}")
    return rng.permutation(np.clip(v, lo, hi).astype(np.int64))


def generate(traffic: dict, workload: dict, vocab: int, seed: int,
             seconds: float) -> list[Arrival]:
    """The requests of one window, sorted by due time.  The shared prefix
    (``prefix_tokens``) is the same for every seed; everything else is
    drawn from ``seed``."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xBE7C])
    arr = traffic["arrivals"]
    if arr["kind"] == "backlog":
        n = int(np.ceil(workload["backlog_per_s"] * seconds))
        due = np.zeros(n)
    else:
        due = arrival_times(arr, float(workload["rate_per_s"]), seconds, rng)
        n = len(due)
    plen = lengths(traffic["prompt"], n, rng)
    olen = lengths(traffic["output"], n, rng)
    n_prefix = int(traffic.get("prefix_tokens", 0))
    prefix = np.random.default_rng(zlib.crc32(b"prefix")).integers(
        0, vocab, n_prefix, dtype=np.int64).astype(np.int32)
    out = []
    for i in range(n):
        body = rng.integers(0, vocab, int(plen[i]), dtype=np.int64).astype(np.int32)
        out.append(Arrival(rid=i, due_s=float(due[i]),
                           prompt=np.concatenate([prefix, body]),
                           max_new_tokens=int(olen[i])))
    return out


__all__ = ["Arrival", "arrival_times", "burst_profile", "generate", "lengths"]
