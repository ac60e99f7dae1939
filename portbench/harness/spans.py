"""The program's own spans in a traced window (``diffsim.<name>``, recorded by
``diffsim_tpu_torch/runtime/profiling.py`` on the profiler's clock), for the metrics that read
them: the host time of some spans inside each of the window's calls, and the device's idle gaps
that begin inside some spans. A trace without any such span (a program that records none) reads
None, never 0.
"""

from __future__ import annotations

import bisect
import statistics

from portbench.harness.trace import GAP_LABEL_MIN_S, merged

PREFIX = "diffsim."
CALL = "portbench.dispatch"  # the harness's span around each closed-loop call


def _program_spans(trace) -> list:
    return [h for h in trace.host if h[0].startswith(PREFIX)]


def per_call_ms(trace, match) -> float | None:
    """The median over the window's calls of the host time, in ms, covered by the program's
    spans inside the call whose name ``match(name)`` accepts (a call with none counts 0)."""
    if trace is None:
        return None
    spans = _program_spans(trace)
    calls = [(s, e) for n, s, e in trace.host if n == CALL]
    if not spans or not calls:
        return None
    hit = sorted((h for h in spans if match(h[0])), key=lambda h: h[1])
    starts = [h[1] for h in hit]
    totals = []
    for s, e in calls:
        inside = hit[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)]
        totals.append(sum(b - a for a, b in merged([(n, a, min(b, e)) for n, a, b in inside],
                                                    trace.window_s)))
    return 1e3 * statistics.median(totals)


def idle_share_pct(trace, match) -> float | None:
    """The share of the window, in %, of device-idle gaps of at least ``GAP_LABEL_MIN_S`` (the
    breakdown's) that begin while the host is inside a program span ``match(name)`` accepts."""
    if trace is None or not trace.device:
        return None
    spans = _program_spans(trace)
    if not spans:
        return None
    inside = merged([h for h in spans if match(h[0])], trace.window_s)
    starts = [s for s, _ in inside]
    idle = prev = 0.0
    for s, e in merged(trace.device, trace.window_s) + [(trace.window_s, trace.window_s)]:
        if s - prev >= GAP_LABEL_MIN_S:
            i = bisect.bisect_right(starts, prev) - 1
            if i >= 0 and inside[i][1] >= prev:
                idle += s - prev
        prev = max(prev, e)
    return 100.0 * idle / trace.window_s
