"""Serving workload: a bursty request stream whose arrival intensity follows
the paper's match-trace structure (the LLM analogue of the tweet workload).

Counterpart of ``request_stream`` in ``repro.data.pipeline``; the training
token stream is not ported yet.
"""
from __future__ import annotations

import numpy as np


def request_stream(*, n_requests: int, seed: int = 0, mean_prompt: int = 64,
                   mean_decode: int = 32, burst_times=(), burst_scale: float = 4.0,
                   horizon_s: float = 600.0):
    """Bursty serving workload: Poisson base + multiplicative bursts
    (the paper's Fig-4 structure mapped onto LLM requests).

    Yields (arrival_s, prompt_len, decode_len) sorted by arrival.
    """
    rng = np.random.default_rng(seed)
    n_sec = int(horizon_s)
    lam = np.ones(n_sec) * (n_requests / n_sec)
    t = np.arange(n_sec, dtype=np.float64)
    for b in burst_times:
        prof = np.where(t < b, np.exp(-((t - b) ** 2) / (2 * 20.0 ** 2)),
                        np.exp(-(t - b) / 60.0))
        lam = lam * (1.0 + (burst_scale - 1.0) * prof)
    lam *= n_requests / lam.sum()
    counts = rng.poisson(lam)
    out = []
    for sec, c in enumerate(counts):
        for _ in range(c):
            out.append((
                sec + rng.random(),
                max(int(rng.exponential(mean_prompt)), 4),
                max(int(rng.exponential(mean_decode)), 1),
            ))
    out.sort()
    return out


__all__ = ["request_stream"]
