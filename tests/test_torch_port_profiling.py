"""The port's spans (``diffsim_tpu_torch/runtime/profiling.py``) on the CPU: the gate on the
process-wide profiler flag, the stage spans of a tiny SD-1.5 scorer's calls nested under the
call's span, the batcher's spans in ``profiling.trace``'s Chrome trace from the batcher's own
thread, and the batcher's counters, also in ``GET /healthz``."""

import contextlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from diffsim_tpu_torch.cli.args import arg_parse
from diffsim_tpu_torch.cli.serve import Batcher, _Work, make_server
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
from diffsim_tpu_torch.metrics.registry import _tiny_configs
from diffsim_tpu_torch.runtime import profiling

STAGES = ("prompts", "guard", "vae", "noise", "unet", "readout")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof) -> list:
    """(name, start_ns, end_ns) of the ``diffsim.`` spans the profiler recorded."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("diffsim."):
            out.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return sorted(out, key=lambda e: e[1])


def _inside(spans, outer) -> set:
    """The names of the spans that lie inside ``outer`` (its children and theirs)."""
    _, s, e = outer
    return {n for n, a, b in spans if (a, b) != (s, e) and s <= a and b <= e}


def test_tracing_follows_the_process_wide_profiler_flag():
    # the private flag the gate reads: a rename in torch must fail here, not silence the spans
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert profiling.tracing() is False
    seen = {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing() is True
        t = threading.Thread(target=lambda: seen.setdefault("thread", profiling.tracing()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen["thread"] is True  # torch.autograd._profiler_enabled() reads False there
    assert profiling.tracing() is False


def test_span_is_one_shared_null_context_without_a_profiler():
    a, b = profiling.span("unet"), profiling.span("sync.model_t")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:  # re-entrant, and it records nothing: a later profiler sees no such span
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("unet"):
            pass
    assert [n for n, _, _ in _spans(prof)] == ["diffsim.unet"]


def test_stage_timer_stages_are_spans():
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("dispatch"):
            pass
    assert [n for n, _, _ in _spans(prof)] == ["diffsim.stage.dispatch"]
    assert timer.counts["dispatch"] == 1


@pytest.fixture(scope="module")
def scorer():
    return DiffSimSD15(img_size=32, device="cpu", **_tiny_configs("diffsim"))


def _pixels(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)


def test_scorer_calls_emit_their_stage_spans(scorer):
    roles = [[f"span_{r}{i}" for i in range(2)] for r in "abc"]
    pix = [_pixels(2, s) for s in range(3)]
    kw = dict(prompt="p", target_layer=(0,), target_step=600)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fetch = scorer.score_triplet_paths(*roles, *pix, blocking=False, **kw)
        fetch()
        scorer.score_triplet_paths(*roles, blocking=False, **kw)()  # every image a hit
        scorer.score_batch(pix[0], pix[1], **kw)
    spans = _spans(prof)
    calls = [s for s in spans if s[0] == "diffsim.score_triplet_paths"]
    assert len(calls) == 2
    first, hits = (_inside(spans, c) for c in calls)
    want = {f"diffsim.{s}" for s in STAGES}
    assert want | {"diffsim.cache.fill", "diffsim.sync.slots", "diffsim.sync.cache_pixels",
                   "diffsim.sync.cache_slots", "diffsim.sync.role_index",
                   "diffsim.sync.prompt_index", "diffsim.sync.model_t"} <= first
    assert want - {"diffsim.vae"} <= hits and "diffsim.cache.fill" not in hits
    assert "diffsim.fetch" not in first  # blocking=False: fetched after the call returned
    assert sum(n == "diffsim.fetch" for n, _, _ in spans) == 3
    (pair,) = [s for s in spans if s[0] == "diffsim.score_batch"]
    inner = _inside(spans, pair)
    assert want | {"diffsim.sync.pixels", "diffsim.fetch"} <= inner
    for names in (first, hits, inner):
        assert any(n.startswith("diffsim.sync.") for n in names)
        assert not any(n.startswith("diffsim.score_") for n in names)


def _round_trip(batcher, sizes):
    return [batcher.submit(_Work(np.zeros((k, 2, 2, 3), np.uint8),
                                 np.zeros((k, 2, 2, 3), np.uint8), ["p"] * k))
            for k in sizes]


def _zeros(pa, pb, prompts):
    return np.zeros(len(prompts), np.float32)


def test_batcher_spans_reach_the_trace_from_its_thread(tmp_path):
    batcher = Batcher(_zeros, max_batch=4, max_wait_ms=1.0)  # its thread runs before the trace
    try:
        with profiling.trace(str(tmp_path)):
            _round_trip(batcher, [2])
    finally:
        batcher.close()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    rounds = [e for e in events if e.get("name") == "diffsim.batcher.round"]
    assert len(rounds) == 1
    assert rounds[0]["tid"] != threading.get_native_id()


def test_batcher_stats_count_rounds_pairs_and_requests():
    batcher = Batcher(_zeros, max_batch=4, max_wait_ms=1.0)
    try:
        works = _round_trip(batcher, [1, 2, 9])  # 9 pairs: chunks of 4, 4 and 1
    finally:
        batcher.close()
    assert [len(w.scores) for w in works] == [1, 2, 9]
    stats = batcher.stats
    assert {k: stats[k] for k in ("rounds", "pairs", "requests")} == {
        "rounds": 5, "pairs": 12, "requests": 3}
    assert stats["queue_wait_s"] > 0.0


def test_healthz_reports_the_batcher_stats(tmp_path):
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"im{i}.png"))
        Image.fromarray(_pixels(1, i)[0]).save(paths[-1])
    flags = ["--metric", "diffsim", "--model_scale", "tiny", "--image_size", "32",
             "--target_layer", "0", "--target_step", "600", "--batch_size", "4"]
    srv, batcher = make_server(arg_parse(flags), port=0, max_wait_ms=1.0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for pairs in ([paths], [paths, paths[::-1]]):
            req = urllib.request.Request(url + "/score", data=json.dumps(
                {"pairs": pairs, "prompt": "x"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert len(json.loads(r.read())["scores"]) == len(pairs)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
        t.join(timeout=30)
    assert not t.is_alive()
    assert h["pending"] == 0 and (h["rounds"], h["pairs"], h["requests"]) == (2, 3, 2)
    assert h["queue_wait_s"] == batcher.stats["queue_wait_s"] > 0.0
