"""The metric readers on synthetic windows and profiler events."""

import sys
import types

import pytest

from portbench.harness import cli, drive, peaks
from portbench.harness.trace import Trace
from portbench.harness.work import Work

K1 = "void attention_wgmma<160, false>(CUtensorMap, CUtensorMap, CUtensorMap, bf16*, int)"


def _done(pairs=48, rows=144, images=7, latency=10.0, ok=True):
    return drive.Done(None, 1 if ok else None, images, rows, pairs, latency_ms=latency)


def _reading(**kw):
    w = drive.Window(0.0, 2.0, [_done(), _done()], 2, enqueue_ms=[3.0, 5.0, 4.0],
                     rounds=[(2, 30.0), (4, 50.0)])
    trace = Trace([(K1, 0.10, 0.30), (K1, 0.50, 0.70), ("elementwise", 0.2, 0.4)],
                  [("portbench.window", 0.0, 1.0), ("portbench.fetch", 0.7, 1.0),
                   ("aten::_local_scalar_dense", 0.69, 0.99)], 1.0)
    r = types.SimpleNamespace(
        cell="c", config={"dtype": "bfloat16", "part_dtypes": {"vae": "bfloat16"}}, window=w,
        setup_s=12.5, memory_peak_bytes=3 * 2 ** 30, trace=trace,
        work=Work(1e12, 2e12, 1e9, ((8, 256, 160), (8, 64, 160)), ()),
        before={"cache": {"hits": 10, "misses": 5}, "launches": {"fused_self_attention": 4}},
        after={"cache": {"hits": 100, "misses": 15}, "launches": {"fused_self_attention": 6}})
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def read(name, r):
    return cli.reader(name)(r)


def test_host_and_counter_readers():
    r = _reading()
    assert read("pairs_per_s", r) == 48.0
    assert read("setup_s", r) == 12.5
    assert read("enqueue_ms", r) == 4.0
    assert read("cache_hit_pct", r) == 90.0
    assert read("round_pairs.serve", r) == 3.0 and read("round_ms.serve", r) == 40.0
    assert read("peak_mem_gib", r) == 3.0


def test_a_new_file_is_found_by_its_name(tmp_path, monkeypatch):
    """A metric, a kind of mix or a reference added as a file is found by the name a data file
    or ``BENCHMARK.json`` gives it, with no edit to the harness."""
    from portbench.harness import by_name, system, traffic

    for folder, src in (("metrics", "def read(r):\n    return 7.0\n"),
                        ("traffic", "def prepare(run):\n    return 'kind'\n"),
                        ("reference", "def work_of(config):\n    return 'ref'\n")):
        (tmp_path / folder).mkdir()
        (tmp_path / folder / "new_by_test.x.py").write_text(src)
    monkeypatch.setattr(by_name, "HERE", str(tmp_path))
    try:
        assert cli.reader("new_by_test.x")(None) == 7.0
        assert traffic.kind({"kind": "new_by_test.x"}).prepare(None) == "kind"
        assert system.reference_of({"reference": "new_by_test.x"}).work_of(None) == "ref"
        with pytest.raises(FileNotFoundError):
            by_name.module("metrics", "no_such_metric")
    finally:
        for folder in ("metrics", "traffic", "reference"):
            sys.modules.pop(f"portbench_{folder}_new_by_test.x", None)


def test_device_readers():
    r = _reading()
    assert read("device_idle_pct", r) == pytest.approx(50.0)  # busy 0.1-0.4 and 0.5-0.7
    assert r.trace.idle_gaps()[0] == ["portbench.fetch / aten::_local_scalar_dense",
                                      pytest.approx(0.3)]
    bound = 288 * peaks.attention_bound_s(1, 8, 256, 160, 2)  # the 64-token site: no K1
    assert read("k1_roofline", r) == pytest.approx(100 * bound / 0.4)
    flops = 2 * (144e12 + 7 * 2e12 + 48e9)
    assert read("mfu_pct", r) == pytest.approx(100 * flops / peaks.PEAK_BF16)


def test_device_readers_find_nothing_without_a_trace_or_with_a_counter_mismatch():
    assert read("k1_roofline", _reading(trace=None)) is None
    assert read("device_idle_pct", _reading(trace=None)) is None
    r = _reading()
    r.after["launches"]["fused_self_attention"] = 9
    assert read("k1_roofline", r) is None


def test_metrics_of_a_cell(bench):
    names = [m["name"] for m in cli.metrics_of(bench, "sd15-serve-over", False)]
    assert names == ["pairs_per_s", "setup_s"]
    per = {m["name"] for m in cli.metrics_of(bench, "sd15-serve-over", True)}
    assert {"round_pairs.serve", "round_ms.serve", "mfu_pct"} <= per
    assert "enqueue_ms" not in per and "cache_hit_pct" not in per
    per = {m["name"] for m in cli.metrics_of(bench, "sdxl-1024-reuse", True)}
    assert {"k1_roofline", "cache_hit_pct", "mfu_pct", "device_idle_pct"} <= per
    assert "round_ms.serve" not in per
