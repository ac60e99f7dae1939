"""enqueue_ms: the median over the window's calls of the host time a ``blocking=False``
scoring call takes to return (the benchmark's host clock around it)."""

import statistics


def read(r):
    return statistics.median(r.window.enqueue_ms) if r.window.enqueue_ms else None
