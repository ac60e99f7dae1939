"""The port's 2AFC CLI path on the CPU (``python -m diffsim_tpu_torch.cli.main``): the host
modules it copies from the JAX package held to their originals (planners, decision rules,
presets, the resumable result log), and ``run_benchmark`` end to end on the tiny on-disk fixtures
with the tiny models, through the device moment cache and without it."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from diffsim_tpu.cli import args as jargs
from diffsim_tpu.data import benchmarks as jbench
from diffsim_tpu.runtime import results as jresults
from diffsim_tpu.runtime import runner as jrunner
from diffsim_tpu_torch.cli import args as targs
from diffsim_tpu_torch.cli.main import BENCHMARKS, run_benchmark
from diffsim_tpu_torch.core.image import ImageLoader
from diffsim_tpu_torch.data import benchmarks as tbench
from diffsim_tpu_torch.runtime import results as tresults
from diffsim_tpu_torch.runtime import runner as trunner
from diffsim_tpu_torch.runtime.profiling import StageTimer
from tests import fixtures

CACHED_ATOL = 2e-6  # cached vs fresh scores (tests/test_torch_port_cache.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    ipref, ipref_orig = fixtures.make_ipref(root)
    return dict(cute=fixtures.make_cute(root), style=fixtures.make_style(root),
                nights=fixtures.make_nights(root), tid=fixtures.make_tid(root), ipref=ipref,
                ipref_orig=ipref_orig, dreambench=fixtures.make_dreambench(root))


PLANS = {
    "cute": lambda m, d, seed: m.cute(d["cute"], seed),
    "style": lambda m, d, seed: m.style(d["style"], seed, "High quality image", num_triplets=50),
    "nights": lambda m, d, seed: m.nights(d["nights"], seed),
    "tid2013": lambda m, d, seed: m.tid2013(d["tid"], seed),
    "ipref": lambda m, d, seed: m.ipref(d["ipref"], d["ipref_orig"], seed),
    "dreambench": lambda m, d, seed: m.dreambench(d["dreambench"], seed, "High quality image"),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("seed", [2334, 1])
def test_planners_match_jax(data, plan, seed):
    ours = PLANS[plan](tbench, data, seed)
    ref = PLANS[plan](jbench, data, seed)
    assert ours and [dataclasses.asdict(c) for c in ours] == [dataclasses.asdict(c) for c in ref]


@pytest.mark.parametrize("rule", [trunner.STANDARD, trunner.ALWAYS_GREATER, trunner.VOTE,
                                  trunner.VOTE_GREATER])
@pytest.mark.parametrize("lower_better", [False, True])
def test_judge_matches_jax(rule, lower_better):
    rng = np.random.default_rng(0)
    for s_ab, s_ac, vote in zip(rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                                rng.integers(0, 2, 200)):
        assert trunner.judge(rule, s_ab, s_ac, int(vote), lower_better) == \
            jrunner.judge(rule, s_ab, s_ac, int(vote), lower_better)
    with pytest.raises(ValueError):
        trunner.judge("nope", 0.0, 0.0, None, False)


@pytest.mark.parametrize("preset", sorted(jargs.PRESETS))
def test_presets_match_jax(preset):
    """The same presets, expanded the same way, parse to the same values of every shared
    flag; an explicit flag overrides its preset."""
    assert targs.PRESETS[preset] == jargs.PRESETS[preset]
    argv = ["--preset", preset, "--image_path", "x", "--seed", "7"]
    assert targs.expand_preset(argv) == jargs.expand_preset(argv)
    ours, ref = vars(targs.arg_parse(argv)), vars(jargs.arg_parse(argv))
    assert ours["seed"] == 7
    assert {k: ours[k] for k in ours if k in ref} == {k: ref[k] for k in ours if k in ref}
    assert set(ours) == set(ref)  # every flag of the JAX CLI parses


def test_result_log_resume_matches_jax(tmp_path):
    """Either package resumes from the other's JSONL: the same records, appended after."""
    path = str(tmp_path / "r.jsonl")
    log = tresults.ResultLog(path)
    log.record(0, s_ab=0.5, s_ac=0.25)
    log.record(2, s_ab=0.1, s_ac=0.2)
    log.close()
    ref = jresults.ResultLog(path)
    assert ref.done == tresults.ResultLog(path).done == {
        0: {"idx": 0, "s_ab": 0.5, "s_ac": 0.25}, 2: {"idx": 2, "s_ab": 0.1, "s_ac": 0.2}}
    ref.record(1, s_ab=0.3, s_ac=0.4)
    ref.close()
    assert sorted(tresults.ResultLog(path).done) == [0, 1, 2]


def _cute_argv(data, *extra):
    return ["--preset", "cute", "--image_path", data["cute"], "--image_size", "32",
            "--model_scale", "tiny", "--batch_size", "8", *extra]


def _scores(path):
    recs = [json.loads(line) for line in open(path)]
    return {r["idx"]: (r["s_ab"], r["s_ac"]) for r in recs}


def test_cute_cached_matches_fresh_and_resumes(data, tmp_path):
    cached_path, fresh_path = str(tmp_path / "cached.jsonl"), str(tmp_path / "fresh.jsonl")
    report, (adapter,) = run_benchmark("cute", _cute_argv(data, "--results", cached_path),
                                    device="cpu")
    fresh, (fresh_adapter,) = run_benchmark(
        "cute", _cute_argv(data, "--results", fresh_path, "--no_device_cache"), device="cpu")
    assert report.total == fresh.total == 40
    stats = adapter.scorer._moment_cache.stats
    # 16 images on disk; each is encoded once, every other reference is a hit
    assert stats["misses"] == stats["resident"] == 16 and stats["hits"] == 3 * 40 - 16
    assert fresh_adapter.scorer._moment_cache is None and fresh_adapter.score_triplet_paths is None
    a, b = _scores(cached_path), _scores(fresh_path)
    assert sorted(a) == list(range(40))
    np.testing.assert_allclose(np.array([a[i] for i in a]), np.array([b[i] for i in a]),
                               atol=CACHED_ATOL)
    assert (report.correct, report.correct_2x) == (fresh.correct, fresh.correct_2x)
    # resume: every row is done, so the rerun scores nothing and appends nothing
    lines = open(cached_path).read()
    again, (adapter2,) = run_benchmark("cute", _cute_argv(data, "--results", cached_path),
                                    device="cpu")
    assert open(cached_path).read() == lines
    assert (again.total, again.correct) == (report.total, report.correct)
    assert adapter2.scorer._moment_cache is None


def test_cute_partial_results_resume_only_the_rest(data, tmp_path):
    path = str(tmp_path / "r.jsonl")
    full, _ = run_benchmark("cute", _cute_argv(data), device="cpu")
    with open(path, "w") as f:
        for i in range(0, 40, 2):
            f.write(json.dumps({"idx": i, "s_ab": 1.0, "s_ac": 0.0}) + "\n")
    report, (adapter,) = run_benchmark("cute", _cute_argv(data, "--results", path), device="cpu")
    assert report.total == 40 and len(_scores(path)) == 40
    assert adapter.scorer._moment_cache.stats["hits"] + \
        adapter.scorer._moment_cache.stats["misses"] == 3 * 20  # only the 20 rows left


def test_cli_shard_profile_and_trace(data, tmp_path, capsys):
    report, _ = run_benchmark("cute", _cute_argv(data, "--shard", "1/4", "--profile",
                                                 "--profile_trace", str(tmp_path / "tr")),
                              device="cpu")
    out = capsys.readouterr().out
    assert report.total == 10 and "shard 1/4: 10 comparisons" in out
    assert "[profile] " in out and "dispatch" in out
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


@pytest.mark.parametrize("command, extra, match", [
    ("cute", ["--num_devices", "2"], "torchrun --nproc_per_node 2 -m diffsim_tpu_torch.cli.main"),
    ("serve", ["--num_devices", "2"],
     "torchrun --nproc_per_node 2 -m diffsim_tpu_torch.cli.serve"),
])
def test_unported_options_raise(data, tmp_path, command, extra, match, monkeypatch):
    """``--num_devices`` other than the process group's size (1 outside torchrun) raises in the
    CLI and in the service (``python -m diffsim_tpu_torch.cli.serve``), naming the torchrun
    command that would run it, before any model is built."""
    from diffsim_tpu_torch.cli import serve
    from diffsim_tpu_torch.metrics import registry

    def no_model(*args, **kwargs):
        raise AssertionError("a model was built before the check")

    monkeypatch.setattr(registry, "_diffusion", no_model)
    with pytest.raises(ValueError, match=match):
        if command == "serve":
            serve.main(extra + ["--port", "0"])
        else:
            run_benchmark("cute", _cute_argv(data, *extra), device="cpu")


def test_cute_with_the_dit_metric_runs_through_the_moment_cache(data, tmp_path):
    """``--metric dit`` (tiny DiT at 32 px) end to end: one miss per image, the scores of the
    cached path equal the fresh triplet path's."""
    path = str(tmp_path / "dit.jsonl")
    argv = ["--preset", "cute", "--image_path", data["cute"], "--image_size", "32",
            "--model_scale", "tiny", "--metric", "dit", "--results", path]
    report, (adapter,) = run_benchmark("cute", argv, device="cpu")
    assert report.total == 40 and type(adapter.scorer).__name__ == "DiffSimDiT"
    stats = adapter.scorer._moment_cache.stats
    assert stats["misses"] == stats["resident"] == 16 and stats["hits"] == 3 * 40 - 16
    fresh_path = str(tmp_path / "fresh.jsonl")
    fresh, _ = run_benchmark("cute", argv[:-1] + [fresh_path, "--no_device_cache"],
                             device="cpu")
    a, b = _scores(path), _scores(fresh_path)
    assert sorted(a) == list(range(40))
    np.testing.assert_allclose(np.array([a[i] for i in a]), np.array([b[i] for i in a]),
                               atol=CACHED_ATOL)
    assert np.isfinite(np.array(list(a.values()))).all()


def test_cli_needs_the_card_unless_told(data, monkeypatch):
    """Without a CUDA device and without ``device``, the CLI refuses to score on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmark("cute", _cute_argv(data))


def test_benchmark_table_matches_jax():
    from diffsim_tpu.cli import main as jmain

    assert {k: v[1] for k, v in BENCHMARKS.items()} == \
        {k: v[1] for k, v in jmain.BENCHMARKS.items()}


def test_image_loader_caches_by_path_and_mtime(tmp_path):
    from PIL import Image

    calls = []

    def prep(img):
        calls.append(1)
        return np.asarray(img.convert("RGB"), np.uint8)[None]

    path = tmp_path / "a.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    loader = ImageLoader(8, preprocess=prep)
    try:
        first = loader.load_batch([str(path), str(path)])
        loader.submit(str(path)).result()
        assert len(calls) <= 2 and first.shape == (2, 8, 8, 3)
        n = len(calls)
        Image.fromarray(np.full((8, 8, 3), 9, np.uint8)).save(path)
        os.utime(path, ns=(1, 10**18))  # a new mtime: the LRU key changes
        assert loader.submit(str(path)).result()[0, 0, 0, 0] == 9 and len(calls) == n + 1
    finally:
        loader.close()


def test_stage_timer_summary():
    timer = StageTimer()
    with timer.stage("a"):
        pass
    with timer.stage("a", sync_value=torch.zeros(1)):
        pass
    assert timer.counts["a"] == 2 and timer.summary().startswith("a: ")
