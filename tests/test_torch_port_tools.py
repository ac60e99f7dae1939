"""The port's retrieval and result tools on the CPU, against the JAX package's: ``retrieval rank``
by the pair route (a query identical to a gallery image ranks it first; with the same DINO
weights the ranking file equals the JAX tool's) and through the moment cache (equal to the pair
route, one miss per image), ``grid`` and ``_read_ranked_paths``, ``compare_results`` on a JAX
and a port result JSONL, and ``runtime/viz.attention_heatmap``. Tiny models,
``device="cpu"``; ``grid`` and the heat map need matplotlib, which the CPU test machine has
(the card's machine does not)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from diffsim_tpu.cli import compare_results as jcompare
from diffsim_tpu.cli import main as jmain
from diffsim_tpu.cli import retrieval as jretrieval
from diffsim_tpu.models import dinov2 as jd
from diffsim_tpu.runtime import viz as jviz
from diffsim_tpu_torch.cli import compare_results as tcompare
from diffsim_tpu_torch.cli import retrieval as tretrieval
from diffsim_tpu_torch.cli.main import run_benchmark
from diffsim_tpu_torch.convert import store
from diffsim_tpu_torch.runtime import viz as tviz
from tests import fixtures

SCORE_ATOL = 5e-5  # the port's baselines against JAX (tests/test_torch_port_baselines_cli.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A gallery of five images and one query pixel-identical to g2."""
    root = tmp_path_factory.mktemp("retrieval")
    gal, q = root / "gallery", root / "queries"
    gal.mkdir()
    q.mkdir()
    for i in range(5):
        fixtures._img(300 + i).save(gal / f"g{i}.png")
    fixtures._img(302).save(q / "q0.png")
    return str(gal), str(q)


@pytest.fixture(scope="module")
def dino_npz(tmp_path_factory):
    rng = np.random.default_rng(0)
    tree = jax.device_get(jd.init(jax.random.PRNGKey(0), jd.DinoConfig.tiny()))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tree = jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32) for x in leaves])
    path = str(tmp_path_factory.mktemp("weights") / "dino.npz")
    store.save_params(path, tree)
    return path


def _read(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [ln.split()[0] for ln in lines], [float(ln.split()[1]) for ln in lines]


def _rank_argv(images, out, *extra):
    gal, q = images
    return ["--query_path", q, "--gallery_path", gal, "--out_path", str(out),
            "--model_scale", "tiny", "--image_size", "32", *extra]


def test_rank_pair_route_puts_the_identical_image_first(images, tmp_path):
    """``rank`` with clip_i (the pair route): "<name> <score>" lines best first, the query's
    pixel-identical gallery image on top (cosine self-similarity)."""
    out = tmp_path / "rank_clip"
    adapter = tretrieval.rank(_rank_argv(images, out, "--metric", "clip_i", "--batch_size", "4"),
                              device="cpu")
    assert adapter.score_triplet_paths is None
    names, scores = _read(out / "q0.txt")
    assert len(names) == 5 and names[0] == "g2"
    assert scores == sorted(scores, reverse=True)


def test_rank_matches_the_jax_tool(images, dino_npz, tmp_path):
    """DINO draws no noise: with the same weights the port's ranking file equals the JAX
    ``rank``'s, names in order and scores within SCORE_ATOL, and so does ``--top_k``."""
    for top_k in ("0", "3"):
        extra = ("--metric", "dino", "--weights", dino_npz, "--batch_size", "2", "--top_k",
                 top_k)
        tretrieval.rank(_rank_argv(images, tmp_path / f"ours{top_k}", *extra), device="cpu")
        jretrieval.rank(_rank_argv(images, tmp_path / f"ref{top_k}", *extra))
        ours, ref = _read(tmp_path / f"ours{top_k}" / "q0.txt"), _read(
            tmp_path / f"ref{top_k}" / "q0.txt")
        assert ours[0] == ref[0] and len(ours[0]) == (5 if top_k == "0" else 3)
        np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=SCORE_ATOL)


def test_rank_through_the_moment_cache_matches_the_pair_route(images, tmp_path):
    """diffsim ranks through the moment cache, gallery pairs packed two a triplet (an odd
    gallery of five: the last image repeated, the last call one triplet short of the batch);
    its scores and order equal the pair route's (``--no_device_cache``), one miss per image."""
    base = ("--metric", "diffsim", "--batch_size", "2", "--target_layer", "0",
            "--target_step", "600")
    adapter = tretrieval.rank(_rank_argv(images, tmp_path / "cached", *base), device="cpu")
    assert adapter.score_triplet_paths is not None
    stats = adapter.scorer._moment_cache.stats
    assert stats["misses"] == stats["resident"] == 6, stats
    tretrieval.rank(_rank_argv(images, tmp_path / "plain", *base, "--no_device_cache"),
                    device="cpu")
    c_names, c_scores = _read(tmp_path / "cached" / "q0.txt")
    p_names, p_scores = _read(tmp_path / "plain" / "q0.txt")
    assert len(c_names) == 5 and c_names == p_names
    np.testing.assert_allclose(c_scores, p_scores, atol=2e-5)


def test_rank_with_two_devices_raises(images, tmp_path, monkeypatch):
    """``--num_devices 2`` outside a process group of two raises, naming the torchrun command,
    before a model is built."""
    from diffsim_tpu_torch.metrics import registry

    def no_model(*args, **kwargs):
        raise AssertionError("a model was built before the check")

    monkeypatch.setattr(registry, "_baseline", no_model)
    with pytest.raises(ValueError,
                       match="torchrun --nproc_per_node 2 -m diffsim_tpu_torch.cli.retrieval"):
        tretrieval.rank(_rank_argv(images, tmp_path / "r", "--metric", "clip_i",
                                   "--num_devices", "2"), device="cpu")


def test_read_ranked_paths_matches_jax(tmp_path):
    """Names resolve by extension under the origin, then the reference's "<cls>_<imgid>" layout
    (origin/<cls>/<imgid>.png), unresolved names are skipped, and at most k come back."""
    origin = tmp_path / "origin"
    (origin / "cat").mkdir(parents=True)
    for rel in ("a.png", "b.jpg", "cat/7.png", "c.jpeg"):
        fixtures._img(len(rel)).save(origin / rel)
    rank_file = tmp_path / "q.txt"
    rank_file.write_text("a 0.9\n\nmissing 0.8\ncat_7 0.7\nb 0.6\nc 0.5\n")
    for k in (2, 4, 10):
        ours = tretrieval._read_ranked_paths(str(rank_file), str(origin), k)
        assert ours == jretrieval._read_ranked_paths(str(rank_file), str(origin), k)
    assert [os.path.relpath(p, origin) for p in ours] == ["a.png", "cat/7.png", "b.jpg", "c.jpeg"]


def test_grid_matches_jax(images, tmp_path, capsys):
    """``grid`` composes the same [query | top-k] PNG as the JAX tool from the same ranking
    files, and skips a ranking whose query image is missing."""
    gal, q = images
    rdir = tmp_path / "ranks"
    rdir.mkdir()
    (rdir / "q0.txt").write_text("g2 1.0\ng0 0.5\ng4 0.4\ng1 0.3\ng3 0.2\n")
    (rdir / "gone.txt").write_text("g1 1.0\n")
    for name, tool in (("ours", tretrieval), ("ref", jretrieval)):
        tool.grid(["--origin_path", gal, "--rank_dirs", str(rdir), str(rdir), "--query_dir", q,
                   "--out_path", str(tmp_path / name), "--top_k", "3"])
    assert "skipping gone.txt" in capsys.readouterr().out
    ours = np.asarray(Image.open(tmp_path / "ours" / "q0.png"))
    ref = np.asarray(Image.open(tmp_path / "ref" / "q0.png"))
    assert ours.shape == ref.shape and np.array_equal(ours, ref)
    assert not (tmp_path / "ours" / "gone.png").exists()


def test_retrieval_main_needs_a_subcommand(capsys):
    with pytest.raises(SystemExit) as err:
        tretrieval.main(["serve"])
    assert err.value.code == 2 and "{rank|grid}" in capsys.readouterr().out


@pytest.fixture(scope="module")
def result_logs(dino_npz, tmp_path_factory):
    """Result JSONLs of one CUTE plan scored by the JAX CLI and by the port's, with the same
    DINO weights (no noise: equal scores), and by the port with clip_i."""
    tmp = tmp_path_factory.mktemp("results")
    cute = fixtures.make_cute(str(tmp))
    argv = ["--preset", "cute", "--image_path", cute, "--image_size", "32", "--model_scale",
            "tiny", "--batch_size", "8", "--shard", "0/2"]
    logs = {}
    for name, metric in (("port", "dino"), ("jax", "dino"), ("clip", "clip_i")):
        path = str(tmp / f"{name}.jsonl")
        flags = argv + ["--metric", metric, "--results", path]
        if metric == "dino":
            flags += ["--weights", dino_npz]
        if name == "jax":
            jmain.run_benchmark("cute", flags)
        else:
            run_benchmark("cute", flags, device="cpu")
        logs[name] = f"{path}.s0-2"
    return logs


@pytest.mark.parametrize("pair", [("port", "jax"), ("jax", "port"), ("port", "clip")])
def test_compare_results_matches_the_jax_tool(result_logs, capsys, pair):
    """``compare_results`` on a port and a JAX result JSONL prints what the JAX tool prints; the
    same plan scored by both packages with the same weights agrees in every decision (the rank
    correlation is below 1: near-equal scores of the fixture's look-alike images swap places
    within the packages' 5e-5)."""
    files = [result_logs[p] for p in pair]
    tcompare.main(files)
    ours = capsys.readouterr().out
    jcompare.main(files)
    assert ours == capsys.readouterr().out
    out = json.loads(ours)
    assert out["comparisons"] == 20
    if "clip" not in pair:
        assert out["decision_agreement"] == 1.0 and out["spearman"] > 0.99


def test_compare_results_without_overlap_exits(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text(json.dumps({"idx": 0, "s_ab": 1.0, "s_ac": 0.5}) + "\n")
    b.write_text(json.dumps({"idx": 1, "s_ab": 1.0, "s_ac": 0.5}) + "\n")
    with pytest.raises(SystemExit, match="no overlapping"):
        tcompare.main([str(a), str(b)])


@pytest.mark.parametrize("shape", [(2, 3, 16, 4), (1, 25, 6)])
def test_attention_heatmap_matches_jax(tmp_path, shape):
    """The heat map of a (B, heads, S, D) or (B, S, D) tap equals the JAX helper's, and both
    write a PNG."""
    tap = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    ours = tviz.attention_heatmap(tap, str(tmp_path / "ours.png"))
    ref = jviz.attention_heatmap(tap, str(tmp_path / "ref.png"))
    side = int(round(shape[-2] ** 0.5))
    assert ours.shape == (side, side)
    np.testing.assert_array_equal(ours, ref)
    assert (tmp_path / "ours.png").stat().st_size > 0 and (tmp_path / "ref.png").exists()
