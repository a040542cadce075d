"""SignalBus: the monitoring tier of the scaling control plane.

A vectorized windowed aggregator over *named signal channels*.  Each channel
is a pair of per-bin arrays (value sum, sample count) binned at ``bin_s``
resolution.  Samples are indexed by the time the *item was posted*, not the
time its processing finished (§V-B: "it is not the time the tweet is done
being processed that is used ... but the tweets post time"), so a burst of
old items completing late cannot masquerade as a fresh signal rise.

Window means are computed over half-open bin ranges ``[hi - w, hi)`` with the
previous window ``[hi - 2w, hi - w)`` alongside, which is exactly the pair the
paper's appdata detector compares.  The bin arrays grow on demand (unknown
horizons, e.g. a live serving fleet) or can be capped with ``horizon_bins``
(the simulator's fixed-duration traces, where the seed engine clamped both
recording and querying at the trace end).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping

import numpy as np

#: channel name used when a backend does not say otherwise
DEFAULT_CHANNEL = "sentiment"


@dataclass(frozen=True)
class WindowStats:
    """Mean/count of one signal channel over the current and previous window."""

    mean: float = 0.0
    count: int = 0
    prev_mean: float = 0.0
    prev_count: int = 0

    @property
    def rise(self) -> float:
        """Absolute window-over-window rise of the mean."""
        return self.mean - self.prev_mean

    @property
    def relative_rise(self) -> float:
        """Rise relative to the previous window's *level* (0 if no baseline).

        The baseline magnitude is ``abs(prev_mean)`` so a negative baseline
        (paper polarity lives in [-1, 1]) still yields a positive relative
        rise when the mean moves up -- a ``prev_mean > 0`` guard would
        silently report 0 and the appdata trigger could never fire.
        """
        if abs(self.prev_mean) > 1e-6:
            return (self.mean - self.prev_mean) / abs(self.prev_mean)
        return 0.0


class SignalBus:
    """Per-second-binned accumulator for named application-signal channels."""

    def __init__(
        self,
        channels: Iterable[str] = (DEFAULT_CHANNEL,),
        *,
        bin_s: float = 1.0,
        horizon_bins: int | None = None,
    ):
        self.bin_s = float(bin_s)
        self.horizon_bins = horizon_bins
        self._sum: dict[str, np.ndarray] = {}
        self._cnt: dict[str, np.ndarray] = {}
        for name in channels:
            self.add_channel(name)

    # -- channel management ---------------------------------------------------------
    @property
    def channels(self) -> tuple[str, ...]:
        return tuple(self._sum)

    def add_channel(self, name: str) -> None:
        if name not in self._sum:
            n = self.horizon_bins if self.horizon_bins is not None else 256
            self._sum[name] = np.zeros(n, dtype=np.float64)
            self._cnt[name] = np.zeros(n, dtype=np.int64)

    def reset(self) -> None:
        for name in self._sum:
            self._sum[name][:] = 0.0
            self._cnt[name][:] = 0

    # -- recording ------------------------------------------------------------------
    def _bins_of(self, times: np.ndarray) -> np.ndarray:
        b = (np.asarray(times, dtype=np.float64) / self.bin_s).astype(np.int64)
        if self.horizon_bins is not None:
            b = np.minimum(b, self.horizon_bins - 1)
        return np.maximum(b, 0)

    def _ensure(self, name: str, hi_bin: int) -> None:
        cur = self._sum[name].shape[0]
        if hi_bin < cur:
            return
        new = max(hi_bin + 1, 2 * cur)
        if self.horizon_bins is not None:
            new = min(new, self.horizon_bins)
        self._sum[name] = np.concatenate(
            [self._sum[name], np.zeros(new - cur, dtype=np.float64)])
        self._cnt[name] = np.concatenate(
            [self._cnt[name], np.zeros(new - cur, dtype=np.int64)])

    def record(self, channel: str, times, values) -> None:
        """Vectorized: add ``values[i]`` at post time ``times[i]``."""
        times = np.asarray(times, dtype=np.float64)
        if times.size == 0:
            return
        if channel not in self._sum:
            self.add_channel(channel)
        b = self._bins_of(times)
        self._ensure(channel, int(b.max()))
        np.add.at(self._sum[channel], b, np.asarray(values, dtype=np.float64))
        np.add.at(self._cnt[channel], b, 1)

    def record_one(self, channel: str, time: float, value: float) -> None:
        self.record(channel, np.array([time]), np.array([value]))

    # -- window queries --------------------------------------------------------------
    def _clamp_hi(self, hi_bin: int) -> int:
        if self.horizon_bins is not None:
            hi_bin = min(hi_bin, self.horizon_bins)
        return max(hi_bin, 0)

    def window_stats(self, channel: str, hi_bin: int, window_bins: int) -> WindowStats:
        """Stats over ``[hi - w, hi)`` and ``[hi - 2w, hi - w)`` (bins clamped >= 0).

        Uses direct slice sums (numpy pairwise reduction), bit-identical to the
        window means the seed simulator computed inline.
        """
        s, c = self._sum[channel], self._cnt[channel]
        # clamp only by the declared horizon, NOT the allocated length: bins the
        # arrays never grew to are implicitly zero, and clamping to the array
        # length would silently slide the window back onto stale data
        hi = self._clamp_hi(hi_bin)
        w = int(window_bins)
        lo1, hi1 = max(hi - w, 0), hi
        lo0, hi0 = max(hi - 2 * w, 0), max(hi - w, 0)
        c1 = int(c[lo1:hi1].sum())
        c0 = int(c[lo0:hi0].sum())
        m1 = float(s[lo1:hi1].sum() / c1) if c1 else 0.0
        m0 = float(s[lo0:hi0].sum() / c0) if c0 else 0.0
        return WindowStats(mean=m1, count=c1, prev_mean=m0, prev_count=c0)

    def snapshot(self, hi_bin: int, window_bins: int) -> Mapping[str, WindowStats]:
        """WindowStats for every channel at the same window edge."""
        return {name: self.window_stats(name, hi_bin, window_bins)
                for name in self._sum}

    def cumulative(self, channel: str) -> tuple[np.ndarray, np.ndarray]:
        """(cumsum of value sums, cumsum of counts) with a leading 0 -- O(1)
        window sums for offline analysis over many window sizes."""
        s = np.concatenate(([0.0], np.cumsum(self._sum[channel])))
        c = np.concatenate(([0], np.cumsum(self._cnt[channel])))
        return s, c


__all__ = ["DEFAULT_CHANNEL", "SignalBus", "WindowStats"]
