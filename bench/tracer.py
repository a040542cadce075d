"""The device trace of the window's last seconds: ``torch.profiler`` over
the steps between two step boundaries, reduced to what the per-layer
readers need.  The profiler stops at the first step boundary past the
window's close, so the seconds it takes to hand over its events fall
after the window and not inside it.

* ``busy_s``: the union of every device activity's span (kernels, copies,
  sets); ``window_s``: the slice's length on the host clock.
* ``family_s(names)``: the union of the spans of the kernels whose names
  contain any of ``names`` (a kernel's second pass, launched as a
  programmatic dependent, starts early and overlaps its first: the union
  counts the call once).
* ``breakdown``: the device operations that took most time, and the idle
  gaps between device activity summed by the innermost host operation
  that was running at each gap's middle.

The profiler is started once during set-up and stopped at once, so that
its own start-up cost is paid there and not inside the window.
"""
from __future__ import annotations

import heapq
import time

import torch


def _merge(spans):
    """Sorted, disjoint union of (start, end) spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clean(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:96]


class Tracer:
    """Profiles the steps that start in [start_s, start_s + length_s) of
    the window; ``hook`` is the window's step hook."""

    def __init__(self, start_s: float, length_s: float, clock=time.perf_counter):
        self.start_s = start_s
        self.stop_s = start_s + length_s
        self.clock = clock
        self.prof = None
        self.t_on = self.t_off = None
        self.summary = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self, fn) -> None:
        """Start the profiler once around ``fn()`` in set-up."""
        with self._profile():
            fn()
            torch.cuda.synchronize()

    def hook(self, now: float) -> None:
        if self.prof is None and self.t_on is None and now >= self.start_s:
            torch.cuda.synchronize()
            self.prof = self._profile()
            self.prof.start()
            self.t_on = self.clock()
        elif self.prof is not None and self.t_off is None and now >= self.stop_s:
            self._stop()

    def _stop(self) -> None:
        torch.cuda.synchronize()
        self.t_off = self.clock()
        self.prof.stop()

    def finish(self) -> None:
        """Stop a profiler still running at the window's end, then reduce."""
        if self.prof is not None and self.t_off is None:
            self._stop()
        if self.prof is not None:
            self.summary = Summary(self.prof.events(), self.t_off - self.t_on)
            self.prof = None


class Summary:
    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType
        self.window_s = window_s
        self.kernels = []          # (name, start us, end us)
        host = []
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                self.kernels.append((_clean(e.name), tr.start, tr.end))
            elif e.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, e.name))
        self.busy = _merge((s, e) for _, s, e in self.kernels)
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-6
        self._host = sorted(host)

    def family_s(self, names) -> float:
        """Seconds of the union of the spans of the kernels whose names
        contain any of ``names``."""
        spans = [(s, e) for n, s, e in self.kernels if any(x in n for x in names)]
        return sum(e - s for s, e in _merge(spans)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        ops = {}
        for n, s, e in self.kernels:
            ops[n] = ops.get(n, 0.0) + (e - s) * 1e-6
        gaps = [(a[1], b[0]) for a, b in zip(self.busy, self.busy[1:]) if b[0] > a[1]]
        by_host = {}
        # innermost host op at each gap's middle: sweep the gaps in time
        # order over the host ops sorted by start, keeping the started ones
        # in a heap by latest start and dropping those that have ended
        active = []
        j = 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (s + e) / 2
            while j < len(self._host) and self._host[j][0] <= mid:
                hs, he, hn = self._host[j]
                heapq.heappush(active, (-hs, he, hn))
                j += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            label = active[0][2] if active else "python between torch ops"
            by_host[label] = by_host.get(label, 0.0) + (e - s) * 1e-6
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in order],
                "idle_gaps": [[n, v] for n, v in idle]}


__all__ = ["Summary", "Tracer"]
