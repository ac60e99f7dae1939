"""The readers of the program's own spans (``harness/spans.py``: ``unet_enqueue_ms``,
``cache_fill_ms``, ``host_sync_ms``, ``sync_idle_pct``) on a synthetic traced window."""

import types

import pytest

from portbench.harness import cli
from portbench.harness.trace import Trace

NEW = ("unet_enqueue_ms", "cache_fill_ms", "host_sync_ms", "sync_idle_pct")

# three calls: the first and the last with cache misses, the middle all hits; a fetch after
HOST = [
    ("portbench.window", 0.0, 1.0),
    ("portbench.dispatch", 0.0, 0.3),
    ("diffsim.score_triplet_paths", 0.0, 0.29),
    ("diffsim.cache.fill", 0.01, 0.05),
    ("diffsim.sync.cache_pixels", 0.02, 0.03),
    ("diffsim.vae", 0.03, 0.05),
    ("diffsim.sync.slots", 0.06, 0.07),
    ("diffsim.unet", 0.08, 0.20),
    ("cudaMemcpyAsync", 0.021, 0.029),
    ("portbench.dispatch", 0.4, 0.6),
    ("diffsim.score_triplet_paths", 0.4, 0.59),
    ("diffsim.sync.slots", 0.41, 0.43),
    ("diffsim.unet", 0.45, 0.55),
    ("portbench.dispatch", 0.7, 0.9),
    ("diffsim.score_triplet_paths", 0.7, 0.89),
    ("diffsim.cache.fill", 0.71, 0.72),
    ("diffsim.sync.slots", 0.73, 0.74),
    ("diffsim.unet", 0.75, 0.85),
    ("portbench.fetch", 0.9, 1.0),
    ("diffsim.fetch", 0.9, 1.0),
]
DEVICE = [
    ("kernel", 0.0, 0.02),
    ("kernel", 0.025, 0.3),  # a 5 ms gap that begins inside sync.cache_pixels: counted
    ("kernel", 0.42, 0.73),  # a 120 ms gap that begins outside any sync span: not counted
    ("kernel", 0.73001, 0.9),  # 10 us inside sync.slots: under 20 us, not counted
]  # and the 100 ms to the window's end begins in diffsim.fetch, no sync span: not counted


def _reading(host=HOST, device=DEVICE):
    return types.SimpleNamespace(trace=Trace(list(device), list(host), 1.0))


def read(name, r):
    return cli.reader(name)(r)


def test_medians_over_the_calls():
    r = _reading()
    assert read("unet_enqueue_ms", r) == pytest.approx(100.0)  # 120, 100, 100
    assert read("cache_fill_ms", r) == pytest.approx(10.0)  # 40, 0 (all hits), 10
    assert read("host_sync_ms", r) == pytest.approx(20.0)  # 10 + 10, 20, 10


def test_a_call_without_misses_counts_zero():
    host = [h for h in HOST if not (h[0] == "diffsim.cache.fill" and h[1] > 0.5)]
    assert read("cache_fill_ms", _reading(host)) == pytest.approx(0.0)  # 40, 0, 0


def test_only_gaps_that_begin_inside_a_sync_span_count():
    assert read("sync_idle_pct", _reading()) == pytest.approx(0.5)  # 5 ms of 1 s
    # the same gap, begun 1 ms after the copy returned, counts for nothing
    moved = [("kernel", 0.0, 0.031), ("kernel", 0.036, 0.3)] + DEVICE[2:]
    assert read("sync_idle_pct", _reading(device=moved)) == pytest.approx(0.0)


def test_a_program_without_spans_reads_none():
    bare = [h for h in HOST if not h[0].startswith("diffsim.")]
    for name in NEW:
        assert read(name, _reading(bare)) is None
        assert read(name, types.SimpleNamespace(trace=None)) is None


def test_the_reuse_cells_report_them(bench):
    for cell in ("sd15-cute-reuse", "sdxl-1024-reuse"):
        per = {m["name"] for m in cli.metrics_of(bench, cell, True)}
        assert set(NEW) <= per
    per = {m["name"] for m in cli.metrics_of(bench, "sd15-serve-over", True)}
    assert not set(NEW) & per
