"""Application-signal analysis (paper §III-A): the evidence base for `appdata`.

* :func:`lag_correlation_table` -- Table I: Pearson correlation of per-minute mean
  sentiment with tweet volume at lags 0..10 minutes.
* :func:`windowed_variation` -- Fig 3's "sentiment variation" series: difference of
  consecutive window means.
* :func:`burst_lead_report` -- measures how far ahead of each ground-truth burst the
  variation signal fires (the 1-2 minute early warning the paper exploits).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.simulator.workload import Trace
from repro_torch.utils.stats import pearson


def ema(x: np.ndarray, alpha: float) -> np.ndarray:
    """Exponential moving average (the paper smooths the sentiment series)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    acc = x[0] if x.size else 0.0
    for i, v in enumerate(x):
        if np.isnan(v):
            v = acc
        acc = alpha * v + (1.0 - alpha) * acc
        out[i] = acc
    return out


def lag_correlation_table(trace: Trace, max_lag_min: int = 10, ema_alpha: float = 0.35):
    """Pearson(sentiment @ minute t, volume @ minute t+lag) for lag = 0..max_lag.

    Reproduces Table I: ~0.79 at lag 0 decaying slowly to ~0.70 at lag 10.
    """
    sent, vol = trace.minute_series()
    # fill sparse minutes, smooth like the paper ("an exponential moving average is used")
    sent = ema(np.nan_to_num(sent, nan=float(np.nanmean(sent))), ema_alpha)
    rows = []
    for lag in range(max_lag_min + 1):
        s = sent[: sent.size - lag] if lag else sent
        v = vol[lag:]
        rows.append((lag, pearson(s, v)))
    return rows


def windowed_variation(trace: Trace, window_s: float = 120.0,
                       relative: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(times, variation): difference (or relative rise, ``relative=True``) between
    the mean sentiment of consecutive windows of ``window_s``, indexed by tweet post
    time -- the appdata trigger's view.
    """
    w = int(window_s)
    n = trace.duration
    bins = np.minimum(trace.post_time.astype(np.int64), n - 1)
    s_sum = np.bincount(bins, weights=trace.sentiment.astype(np.float64), minlength=n)
    s_cnt = np.bincount(bins, minlength=n)
    csum, ccnt = np.cumsum(s_sum), np.cumsum(s_cnt)

    def wmean(hi):  # mean over [hi-w, hi)
        hi = np.asarray(hi)
        lo = np.maximum(hi - w, 0)
        tot = csum[hi - 1] - np.where(lo > 0, csum[lo - 1], 0.0)
        cnt = ccnt[hi - 1] - np.where(lo > 0, ccnt[lo - 1], 0)
        return np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0)

    times = np.arange(2 * w, n, 60)
    m1, m0 = wmean(times), wmean(times - w)
    if relative:
        var = np.where(m0 > 1e-6, m1 / np.maximum(m0, 1e-6) - 1.0, 0.0)
    else:
        var = m1 - m0
    return times.astype(np.float64), var


def burst_lead_report(trace: Trace, *, jump: float = 0.5, window_s: float = 120.0) -> dict:
    """How well does the sentiment-variation trigger anticipate real bursts?

    A burst counts as *detected* if the relative window-mean rise crosses ``jump``
    within [onset - 240 s, onset + 60 s].  Leads are onset - first-crossing
    (positive = early warning).  Crossings far from any burst are false positives
    (Fig 3 shows "some false positives and a false negative").
    """
    times, var = windowed_variation(trace, window_s, relative=True)
    fire = times[np.nonzero((var >= jump) & (np.concatenate(([0.0], var[:-1])) < jump))[0]]
    leads, detected = [], 0
    for onset in trace.burst_times:
        near = fire[(fire >= onset - 240.0) & (fire <= onset + 60.0)]
        if near.size:
            detected += 1
            leads.append(float(onset - near[0]))
    n_fp = int(sum(1 for f in fire
                   if not any(abs(f - o) <= 300.0 for o in trace.burst_times)))
    return {
        "n_bursts": int(trace.burst_times.size),
        "n_detected": detected,
        "mean_lead_s": float(np.mean(leads)) if leads else float("nan"),
        "n_false_positives": n_fp,
        "n_fires": int(fire.size),
    }


__all__ = ["ema", "lag_correlation_table", "windowed_variation", "burst_lead_report"]
