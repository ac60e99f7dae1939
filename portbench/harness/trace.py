"""``torch.profiler`` over a measured window, reduced to what the per-layer metrics read: the
device's activities (kernels, copies, fills) with their names and times, the host's spans, the
window's bounds, the device's busy time, and the idle gaps labelled by what the host was doing.

The window is the ``portbench.window`` span that the harness records around its loop, in the
trace's own clock. The raw events are read from the profiler's results, not its per-op tables.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

GAP_LABEL_MIN_S = 20e-6  # shorter idle gaps are launch gaps, summed under one label
TOP = 10


@dataclasses.dataclass
class Trace:
    device: list  # (name, start_s, end_s) of each device activity, in the window's clock
    host: list  # (name, start_s, end_s) of each host event
    window_s: float

    def busy_s(self) -> float:
        return float(sum(e - s for s, e in merged(self.device, self.window_s)))

    def device_time(self, match) -> tuple[float, int]:
        """(seconds, count) of the device activities whose name ``match(name)`` accepts."""
        hit = [e - s for n, s, e in self.device if match(n)]
        return float(sum(hit)), len(hit)

    def top_ops(self, n: int = TOP) -> list:
        by = collections.Counter()
        for name, s, e in self.device:
            by[name] += e - s
        return [[name, secs] for name, secs in by.most_common(n)]

    def idle_gaps(self, n: int = TOP) -> list:
        """The idle time between device activities, summed by what the host was doing at the
        start of each gap: the innermost benchmark span and the innermost host op there."""
        bench = _Spans([h for h in self.host if h[0].startswith("portbench.")])
        ops = _Spans([h for h in self.host if not h[0].startswith("portbench.")])
        by = collections.Counter()
        prev = 0.0
        for s, e in merged(self.device, self.window_s) + [(self.window_s, self.window_s)]:
            gap = s - prev
            if gap >= GAP_LABEL_MIN_S:
                label = " / ".join(x for x in (bench.inner(prev), ops.inner(prev)) if x)
                by[label or "no host event"] += gap
            elif gap > 0:
                by["launch gaps under 20 us"] += gap
            prev = max(prev, e)
        return [[name, secs] for name, secs in by.most_common(n)]


class _Spans:
    """Host events sorted by start, to find the innermost one running at a time."""

    def __init__(self, events, back: int = 64):
        self.ev = sorted(events, key=lambda h: h[1])
        self.starts = np.asarray([h[1] for h in self.ev])
        self.back = back

    def inner(self, t: float) -> str | None:
        i = int(np.searchsorted(self.starts, t, side="right")) - 1
        for j in range(i, max(-1, i - self.back), -1):
            if self.ev[j][2] >= t:
                return self.ev[j][0]
        return None


def _annotation(ev) -> bool:
    try:
        return bool(ev.is_user_annotation())
    except AttributeError:
        return False


def merged(intervals, window_s: float) -> list:
    """The union of (name, start, end) intervals clipped to [0, window_s], as (start, end)."""
    ivs = sorted((max(0.0, s), min(window_s, e)) for _, s, e in intervals
                 if e > 0.0 and s < window_s)
    out = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Profiler:
    """Starts ``torch.profiler`` (host and device) for the window; :meth:`result` gives the
    :class:`Trace`."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.start()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        return False

    def result(self) -> Trace:
        events = self.prof.profiler.kineto_results.events()
        host, device = [], []
        t0 = t1 = None
        for ev in events:
            name, s = ev.name(), ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                # the device rows of host annotations (record_function) span whole calls: not
                # device work
                if not (name.startswith("portbench.") or _annotation(ev)):
                    device.append((name, s, e))
            else:
                host.append((name, s, e))
                if name == "portbench.window":
                    t0, t1 = s, e
        if t0 is None:
            raise RuntimeError("the trace holds no portbench.window span")
        return Trace([(n, (s - t0) / 1e9, (e - t0) / 1e9) for n, s, e in device],
                     [(n, (s - t0) / 1e9, (e - t0) / 1e9) for n, s, e in host],
                     (t1 - t0) / 1e9)
