"""The port's spans, per-stage timing and device traces (counterpart of
``diffsim_tpu/runtime/profiling.py``).

* :func:`span` names a stage of the program in ``torch.profiler``'s trace, on the profiler's own
  clock (the device trace's), while a profiler records anywhere in the process; otherwise it is
  one shared null context. Spans mark stages, never single kernel launches; a span never
  synchronises and adds no device work. Every span is ``diffsim.<name>``: a scoring call
  (``score_batch``, ``score_triplet_batch``, ``score_triplet_paths``), its stages (``prompts``,
  ``guard``, ``cache.fill``, ``vae``, ``noise``, ``unet``, ``readout``, ``fetch``), each host
  call that waits for the device (``sync.<site>``), the service's batcher
  (``batcher.round``, ``batcher.idle``), the ``ImageLoader``'s decodes (``loader.decode``) and
  the stages of :class:`StageTimer` (``stage.<name>``).
* :func:`trace` wraps ``torch.profiler`` (CPU and CUDA activities, every thread) and writes a
  Chrome trace into a directory: the CLI's ``--profile_trace``.
* :class:`StageTimer` accumulates wall time per named stage, each also a :func:`span`, and
  prints a one-line breakdown: the 2AFC runner's ``--profile``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a torch profiler records in this process, on any thread. The flag is torch's
    process-wide one: ``torch.autograd._profiler_enabled()`` is per thread, and reads False on a
    worker thread while the main thread profiles."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """``diffsim.<name>`` as a ``record_function`` range while a profiler records, else a
    shared null context (a flag read: no cost to measure)."""
    if tracing():
        return torch.profiler.record_function(f"diffsim.{name}")
    return _OFF


def spanned(name: str):
    """Decorator: the whole call under :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CUDA activity when a card is present) on every
    thread of the process, so that the ``ImageLoader``'s and the batcher's spans are in it, and
    write its Chrome trace to ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulating per-stage host timer; each stage is also the span ``stage.<name>``."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"stage.{name}"):
                yield
        finally:
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
