"""Whole runs of the harness at tiny widths on the CPU (the look for a card skipped): the result
line's keys, and ``correct`` coming out false when the timed path is broken underneath."""

import json
import time

import pytest
import torch

from portbench.harness import cli

CELLS = {"triplet_reuse": "sd15-cute-reuse", "serve_open": "sd15-serve-over"}
LIMITS = {"sample": 1000, "score_gap": 1e-4}  # every answer; float32 on both sides


def _run(bench, tiny, tiny_mixes, kind, trace=False, config="sd15", seconds=1.0):
    cell = next(w for w in bench["workloads"] if w["name"] == CELLS[kind])
    spec = {"bench": bench, "cell": cell, "config": tiny(config), "mix": tiny_mixes[kind],
            "limits": LIMITS}
    return cli.run_cell(spec, 2 ** 33 + 17, seconds, trace, torch.device("cpu"), time.time())


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_result_line_has_its_keys(bench, tiny, tiny_mixes, kind):
    out = _run(bench, tiny, tiny_mixes, kind)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "compared"
    want = {m["name"] for m in cli.metrics_of(bench, CELLS[kind], False)}
    assert set(out["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.loads(json.dumps(out))


def test_traced_line_has_the_per_layer_metrics_and_breakdown(bench, tiny, tiny_mixes):
    out = _run(bench, tiny, tiny_mixes, "triplet_reuse", trace=True)
    assert {"cache_hit_pct", "enqueue_ms", "mfu_pct"} <= set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def _altered(orig):
    def pair_score(*a, **k):  # every answer moved by 1e-3 where the readout produces it
        return orig(*a, **k) + 1e-3
    return pair_score


def _half(orig):
    def pair_score(*a, **k):  # the second half of the batch answered with the first's scores
        s = orig(*a, **k)
        h = (s.shape[0] + 1) // 2
        return torch.cat([s[:h], s[:s.shape[0] - h]])
    return pair_score


@pytest.mark.parametrize("fault", [_altered, _half], ids=["answer_altered", "half_the_batch"])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(bench, tiny, tiny_mixes, kind, fault, monkeypatch):
    from diffsim_tpu_torch.metrics import diffsim_sd15

    monkeypatch.setattr(diffsim_sd15, "pair_score", fault(diffsim_sd15.pair_score))
    if kind == "serve_open" and fault is _half:
        tiny_mixes[kind]["pairs_per_request"] = [2, 2]  # rounds of one pair have no half
    out = _run(bench, tiny, tiny_mixes, kind)
    assert out["correct"] is False
    assert out["compared"]["score_gap"]["value"] > LIMITS["score_gap"]


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "vae_output_in_bf16"])
def test_moment_gap_sees_the_vae_precision(bench, tiny, tiny_mixes, fault, monkeypatch):
    """Where a cell's limits name ``moment_gap``, the moments the program's cache holds are held
    to the reference's: a VAE whose output is rounded to bf16 fails them."""
    from diffsim_tpu_torch.models import vae

    if fault:
        orig = vae.encode_chunked
        monkeypatch.setattr(vae, "encode_chunked",
                            lambda *a, **k: orig(*a, **k).bfloat16().float())
    cell = next(w for w in bench["workloads"] if w["name"] == "sdxl-1024-reuse")
    limits = {**LIMITS, "moment_gap": 1e-4}
    spec = {"bench": bench, "cell": cell, "config": tiny("sdxl"),
            "mix": tiny_mixes["triplet_reuse"], "limits": limits}
    out = cli.run_cell(spec, 2 ** 35 + 3, 1.0, False, torch.device("cpu"), time.time())
    gap = out["compared"]["moment_gap"]["value"]
    assert list(out["compared"]) == ["score_gap", "moment_gap", "failed"]
    assert out["correct"] is (not fault)
    assert (gap > 1e-3) if fault else (gap < 1e-5)
