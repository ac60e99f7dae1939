"""The port's scoring over a process group (``diffsim_tpu_torch/parallel/mesh.py``) on the CPU:
two ranks over gloo (``tests/torch_parallel.py`` spawns them once for this module) against one
rank in the test process and against the JAX package's mesh of two devices.

Scores do not depend on the rank count: each call seeds one generator and shares every draw
across the batch, so two ranks' scores equal one rank's within 1e-5 (float32 sums over other
batch sizes; the JAX package holds its meshes to the same, tests/test_scorer_sd15.py and
tests/test_device_cache.py), and the JAX mesh-of-2 scorer's within 5e-5 (the port against JAX,
tests/test_torch_port_scorer.py). Tiny models, ``device="cpu"``."""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.convert.diffusion_import import convert_sd_unet, convert_vae
from diffsim_tpu.metrics.diffsim_sd15 import DiffSimSD15 as JaxDiffSim
from diffsim_tpu.models import clip_text as jclip
from diffsim_tpu.models import unet as junet
from diffsim_tpu.models import vae as jvae
from diffsim_tpu.parallel import mesh as jmesh
from diffsim_tpu_torch.cli import retrieval
from diffsim_tpu_torch.cli.main import run_benchmark
from diffsim_tpu_torch.core.image import ImageLoader, load_and_process_u8
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
from diffsim_tpu_torch.metrics.registry import build_metric
from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNetConfig
from diffsim_tpu_torch.models.vae import VAEConfig
from diffsim_tpu_torch.parallel import mesh
from tests import fixtures, torch_parallel

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_parity_tiny.npz")
RANKS_ATOL = 1e-5  # two ranks against one
JAX_ATOL = 5e-5  # the port against the JAX scorer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged_params():
    """The tiny SD-1.5 of the committed torch fixture in the JAX layout, the text tower drawn
    from numpy (as tests/test_torch_port_scorer.py builds it)."""
    d = np.load(FIXTURE)
    sds = {"unet": {}, "vae": {}}
    for key in d.files:
        if key.startswith("sd::"):
            _, which, name = key.split("::", 2)
            sds[which][name] = d[key]
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(
        jclip.init(jax.random.PRNGKey(0), jclip.CLIPTextConfig.tiny(), jnp.float32)))
    text = jax.tree_util.tree_unflatten(
        treedef, [(rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32) for x in leaves])
    return {"unet": jax.device_get(convert_sd_unet(sds["unet"], junet.UNetConfig.tiny(),
                                                   strict=True)),
            "vae": jax.device_get(convert_vae(sds["vae"], jvae.VAEConfig.tiny(), strict=True)[0]),
            "text": text}


def _scores(path):
    return {r["idx"]: (r["s_ab"], r["s_ac"]) for r in map(json.loads, open(path))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scoring path once on two ranks and once here on one; the JAX mesh-of-2 scores."""
    root = tmp_path_factory.mktemp("parallel")
    params = _bridged_params()
    rng = np.random.default_rng(1)
    inputs = {"pix": tuple(rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
                           for _ in range(2)),
              "noise": tuple(rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
                             for _ in range(2)),
              "prompts": ["a photo of a dog", "a cat", "x", "y", "z"]}
    kw = dict(prompt=inputs["prompts"], target_block="up_blocks", target_layer=(0,),
              target_step=600, similarity="cosine", noise_override=inputs["noise"])
    jax_scores = JaxDiffSim(params, unet_cfg=junet.UNetConfig.tiny(),
                            vae_cfg=jvae.VAEConfig.tiny(), text_cfg=jclip.CLIPTextConfig.tiny(),
                            img_size=32, dtype=jnp.float32,
                            mesh=jmesh.make_mesh(2)).score_batch(*inputs["pix"], **kw)
    one = {"bridged": DiffSimSD15(params, unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny(),
                                  text_cfg=CLIPTextConfig.tiny(), img_size=32,
                                  dtype=torch.float32, device="cpu").score_batch(
                                      *inputs["pix"], **kw)}

    cute = fixtures.make_cute(str(root / "data"))
    images = sorted(os.path.join(d, f) for d, _, fs in os.walk(cute) for f in fs)
    assert len(images) == 16
    paths = [images[0:8], images[8:16], images[4:12]]  # roles a, b, c of 8 triplets
    pix = [np.concatenate([load_and_process_u8(p, 32) for p in role]) for role in paths]
    for metric in ("diffsim", "dit"):
        adapter = build_metric(torch_parallel.tiny_args(metric), "cpu")
        one[metric] = torch_parallel.score_calls(adapter, pix, paths)
        one[f"{metric}_misses"] = adapter.scorer._moment_cache.stats["misses"]
        if metric == "diffsim":
            serve_pairs = [[paths[0][i], paths[1][i]] for i in range(3)]
            sloader = ImageLoader(32, preprocess=adapter.preprocess)
            one["served"] = adapter.score_pairs(
                sloader.load_batch([a for a, _ in serve_pairs]),
                sloader.load_batch([b for _, b in serve_pairs]), ["a photo"] * 3)

    cli_argv = ["--preset", "cute", "--image_path", cute, "--image_size", "32", "--model_scale",
                "tiny", "--batch_size", "8"]
    one_path, two_path = str(root / "one.jsonl"), str(root / "two.jsonl")
    report, _ = run_benchmark("cute", cli_argv + ["--results", one_path], device="cpu")
    one["cli"] = (report.total, report.correct, report.correct_2x)
    with open(one_path) as src, open(two_path, "w") as dst:
        dst.writelines(line for line in src if json.loads(line)["idx"] % 4 == 0)

    gallery = root / "gallery"
    gallery.mkdir()
    for i in range(5):
        fixtures._img(300 + i).save(gallery / f"g{i}.png")
    rank_base = ["--query_path", images[0], "--gallery_path", str(gallery),
                 "--metric", "diffsim", "--model_scale", "tiny", "--image_size", "32",
                 "--batch_size", "2"]
    retrieval.rank(rank_base + ["--out_path", str(root / "rank_one")], device="cpu")
    two = torch_parallel.run(
        torch_parallel.scoring, 2, root / "spawn", params, inputs, pix, paths, cli_argv,
        two_path, rank_base + ["--out_path", str(root / "rank_two")], serve_pairs)
    return {"one": one, "two": two, "jax": np.asarray(jax_scores), "root": root,
            "one_path": one_path, "two_path": two_path}


def test_two_ranks_score_batch_matches_the_jax_mesh_of_two(runs):
    """``score_batch`` on bridged weights with injected noise, its 5 pairs sharded 3 + 2 over
    the ranks (``registry.over_ranks``), against the JAX scorer on a mesh of 2 and the port on one
    rank; both ranks return every score."""
    a, b = (r["bridged"] for r in runs["two"])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, runs["jax"], rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(a, runs["one"]["bridged"], rtol=0, atol=RANKS_ATOL)
    assert [r["bridged_rows"] for r in runs["two"]] == [3, 2]


@pytest.mark.parametrize("metric", ["diffsim", "dit"])
@pytest.mark.parametrize("path", ["pairs", "triplets", "paths"])
@pytest.mark.parametrize("n", [8, 3, 1])
def test_two_ranks_score_as_one(runs, metric, path, n):
    """The registry's adapters (``build_metric`` in a group of two) on 8, 3 and 1 rows (with 1,
    rank 1 scores nothing and joins the gather): pairs, fused triplets and triplets through the
    moment cache, SD-1.5 and DiT, equal to one rank's within 1e-5 on both ranks."""
    key = f"{path}{n}"
    ref = runs["one"][metric][key]
    for rank in runs["two"]:
        got = rank[metric][key]
        for ours, theirs in zip(*(((g,) if path == "pairs" else g) for g in (got, ref))):
            assert ours.shape == theirs.shape == (n,)
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=RANKS_ATOL)


@pytest.mark.parametrize("metric", ["diffsim", "dit"])
def test_each_rank_scores_and_encodes_only_its_rows(runs, metric):
    """Blocks of ceil(n / 2) rows: 4 + 4, 2 + 1 and 1 + 0 of each path's 8, 3 and 1; each rank's
    moment cache encodes only the images of its own rows: 12 each for the 8 triplets (of the
    16 images), and rank 1 one more for row 2 of the 3 (its image a is rank 0's)."""
    rows = [r[f"{metric}_rows"] for r in runs["two"]]
    assert rows == [dict.fromkeys(("score_pairs", "score_triplets", "score_triplet_paths"), 7),
                    dict.fromkeys(("score_pairs", "score_triplets", "score_triplet_paths"), 5)]
    misses = [r[f"{metric}_misses"] for r in runs["two"]]
    assert misses == [12, 13] and runs["one"][f"{metric}_misses"] == 16


def test_two_rank_cli_resumes_and_writes_once(runs):
    """``cute`` on two ranks, resumed from a log holding every fourth comparison: rank 0
    appends the 30 left, once each, equal to the one-rank run's within 1e-5, and every rank
    reports the same accuracy as one rank; each rank scored 15 of the 30 (batches of 8 on the
    cached path: 4 + 4, ..., 3 + 3)."""
    one, two = _scores(runs["one_path"]), _scores(runs["two_path"])
    lines = open(runs["two_path"]).read().splitlines()
    assert len(lines) == 40 and sorted(two) == list(range(40))
    for i in range(40):
        np.testing.assert_allclose(two[i], one[i], rtol=0, atol=RANKS_ATOL)
    assert [r["cli"] for r in runs["two"]] == [runs["one"]["cli"] + (15,)] * 2


def test_two_rank_rank_writes_the_one_rank_ranking(runs):
    """``retrieval rank`` through the moment cache on two ranks (5 images: calls of 2 and 1
    triplets, the second with nothing for rank 1): rank 0 writes the one-rank ranking (names in
    the same order, scores within 1e-5)."""
    def read(d):
        (name,) = os.listdir(d)
        rows = [line.split() for line in open(os.path.join(d, name))]
        return name, [r[0] for r in rows], np.array([float(r[1]) for r in rows])

    one, two = read(runs["root"] / "rank_one"), read(runs["root"] / "rank_two")
    assert one[:2] == two[:2] and len(one[1]) == 5
    np.testing.assert_allclose(two[2], one[2], rtol=0, atol=RANKS_ATOL)


def test_two_rank_service_round(runs):
    """The service on two ranks: rank 0 serves a request of 3 pairs in one round, broadcast to
    rank 1, which scores its block of 1 pair and stops when the leader closes; the scores equal
    one rank's ``score_pairs`` on the same pixels within 1e-5."""
    leader, follower = runs["two"]
    assert follower["follower_rows"] == 1
    np.testing.assert_allclose(leader["served"], runs["one"]["served"], rtol=0, atol=RANKS_ATOL)


def test_a_failed_follower_ends_the_two_rank_service(tmp_path):
    """A rank that fails in a round leaves the ranks' collectives out of step: the leader answers
    that round with 500 and ``serve.main`` ends with an error (a non-zero exit) instead of
    serving on; the follower ends with its own error."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    leader, follower = torch_parallel.run(torch_parallel.serve_follower_fails, 2, tmp_path,
                                          port)
    assert follower["error"] == "RuntimeError: the follower's scorer failed"
    assert leader["status"] == 500
    assert leader["error"] is not None and "follower" not in leader["error"]
    assert leader["seconds"] < 60


def test_only_the_local_leader_builds_the_kernels(runs):
    """``build.build_on_local_leader`` in a group of two: rank 0 builds (here a stand-in that
    takes 0.5 s), rank 1 builds nothing and returns only after rank 0's build."""
    (built0, t0), (built1, t1) = (r["built"] for r in runs["two"])
    assert len(built0) == 1 and built1 == []
    assert t0 >= 0.5 and t1 >= 0.4


def test_ranks_with_different_weights_raise(runs):
    """``mesh.check_same_weights`` raises on every rank when the ranks' weights differ."""
    for r in runs["two"]:
        assert r["mismatch"] and "different weights" in r["mismatch"]


def test_shard_rows_and_world_without_a_group():
    """Outside a group the port is a group of one: every row is this process's, no collective
    runs, and ``--num_devices`` 1 or None passes."""
    assert not mesh.in_group() and mesh.world() == (0, 1) and mesh.is_leader()
    assert mesh.shard_rows(5) == slice(0, 5)
    t = torch.arange(5.0)
    assert mesh.gather_rows(t, 5) is t
    mesh.check_world_size(None, "m")
    mesh.check_world_size(1, "m")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 -m m"):
        mesh.check_world_size(2, "m")
