"""Per-stage timing and device traces of the port (counterpart of
``diffsim_tpu/runtime/profiling.py``).

* :func:`trace` wraps ``torch.profiler`` (CPU and CUDA activities) and writes a Chrome trace
  into a directory.
* :class:`StageTimer` accumulates wall time per named stage, optionally waiting for the card
  first, and prints a one-line breakdown: the 2AFC runner's ``--profile``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CUDA activity when a card is present) and
    write its Chrome trace to ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulating per-stage timer. ``stage(name, sync_value)`` waits for the card when
    ``sync_value`` is a CUDA tensor, so that the stage's device work is attributed to it."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(sync_value, torch.Tensor) and sync_value.is_cuda:
                torch.cuda.synchronize(sync_value.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        parts = [
            f"{name}: {self.totals[name]:.2f}s ({self.totals[name] / total * 100:.0f}%, "
            f"n={self.counts[name]})"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return " | ".join(parts)

    def report(self, print_fn=print):
        print_fn(f"[profile] {self.summary()}")
