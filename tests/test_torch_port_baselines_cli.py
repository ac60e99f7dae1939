"""The baseline metrics through the port's 2AFC CLI on the CPU, at tiny scale: ``--metric lpips``
and ``--metric dino_cross`` against the JAX CLI comparison by comparison (one ``.npz`` of JAX
weights for both; these metrics draw no noise), ``--metric cute --matting_weights`` against the
JAX CLI too, ``--use_mask --matting_weights`` against the port's own scorer, and ``--metric
ensemble``, whose per-member logs equal the port's single-metric runs, whose report follows the
2-of-3 vote, and which resumes from the intersection of its members' logs. The ensemble runner
itself is held to the JAX runner on stub members, lower- and higher-better, under both vote
rules."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from diffsim_tpu.cli import main as jmain
from diffsim_tpu.data import benchmarks as jbenchmarks
from diffsim_tpu.models import dinov2 as jd
from diffsim_tpu.models import u2net as ju
from diffsim_tpu.models import vgg as jvgg
from diffsim_tpu.runtime import runner as jrunner
from diffsim_tpu_torch.cli.main import run_benchmark
from diffsim_tpu_torch.convert import store
from diffsim_tpu_torch.convert.u2net_import import convert_u2net
from diffsim_tpu_torch.core import image as timage
from diffsim_tpu_torch.data import benchmarks
from diffsim_tpu_torch.metrics.ffa import U2NetMatting
from diffsim_tpu_torch.models import u2net as tu
from diffsim_tpu_torch.runtime import runner as trunner
from tests import fixtures
from tools.torch_u2net import U2Net as MirrorU2Net

SCORE_ATOL = 5e-5
SHARDS, BATCH = 5, 8  # the --use_mask run scores one shard: 8 comparisons, one call
HALF = ["--shard", "0/2"]  # the other runs score comparisons 0, 2, 4, ...: 20 of the 40
N = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fixtures.make_cute(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """``.npz`` files of seeded weights, saved from JAX trees: LPIPS (the full VGG-16 trunk, as
    the registry builds it at any scale), the tiny DINO, FFA's tiny DINO at patch 14, and a tiny
    U^2-Net converted from the torch mirror's state dict by the port's converter."""
    root = tmp_path_factory.mktemp("weights")
    rng = np.random.default_rng(0)

    def redrawn(t, std=0.1):
        leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(t))
        return jax.tree_util.tree_unflatten(treedef, [
            (rng.standard_normal(np.shape(x)) * std).astype(np.float32) for x in leaves])

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    lins = [{"w": np.abs(rng.standard_normal(c)).astype(np.float32)}
            for c in (64, 128, 256, 512, 512)]
    trees = {
        "lpips": {"vgg": jax.device_get(jvgg.init(k1, jvgg.VGG16_CFG)), "lins": lins},
        "dino": redrawn(jd.init(k2, jd.DinoConfig.tiny())),
        "ffa": redrawn(jd.init(k2, dataclasses.replace(jd.DinoConfig.tiny(), patch=14))),
    }
    torch.manual_seed(0)
    cfg = ju.U2NetConfig.tiny()
    mirror = MirrorU2Net(cfg.encoder, cfg.decoder, cfg.side_channels).eval()
    trees["u2net"] = convert_u2net({k: v.numpy() for k, v in mirror.state_dict().items()},
                                   tu.U2NetConfig.tiny())
    paths = {}
    for name, t in trees.items():
        paths[name] = str(root / f"{name}.npz")
        store.save_params(paths[name], t)
    return paths


@pytest.fixture()
def tiny_u2netp(monkeypatch):
    """U2NetMatting's default config (u2netp) at tiny widths in both packages."""
    for m in (ju, tu):
        monkeypatch.setattr(m.U2NetConfig, "u2netp", staticmethod(m.U2NetConfig.tiny))


def _argv(tree, *extra):
    return ["--preset", "cute", "--image_path", tree, "--image_size", "32", "--model_scale",
            "tiny", "--batch_size", "8", *extra]


def _scores(path):
    with open(path) as f:
        return {r["idx"]: (r["s_ab"], r["s_ac"]) for r in map(json.loads, f)}


def _against_jax(tree, tmp_path, *extra):
    """The port's and the JAX CLI's runs of one command line (half the plan): their reports and
    adapter, after holding their logs to each other."""
    ours, ref = str(tmp_path / "ours.jsonl"), str(tmp_path / "ref.jsonl")
    report, (adapter,) = run_benchmark("cute", _argv(tree, *extra, *HALF, "--results", ours),
                                    device="cpu")
    jreport = jmain.run_benchmark("cute", _argv(tree, *extra, *HALF, "--results", ref))
    a, b = _scores(f"{ours}.s0-2"), _scores(f"{ref}.s0-2")
    assert sorted(a) == sorted(b) == list(range(N)) and report.total == jreport.total == N
    got, want = (np.array([s[i] for i in sorted(s)]) for s in (a, b))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    return report, jreport, adapter


@pytest.mark.parametrize("metric", ["lpips", "dino_cross"])
def test_cli_matches_the_jax_cli_comparison_by_comparison(tree, weights, tmp_path, metric):
    """No noise in these metrics: the same weights give the same scores, so the same votes
    (``lpips`` is lower-better: the CLI flips its direction as the JAX CLI does)."""
    npz = weights["lpips" if metric == "lpips" else "dino"]
    report, jreport, adapter = _against_jax(tree, tmp_path, "--metric", metric, "--weights", npz)
    assert adapter.lower_better == (metric == "lpips")
    assert (report.correct, report.correct_2x) == (jreport.correct, jreport.correct_2x)


def test_cli_cute_with_u2net_matting_matches_the_jax_cli(tree, weights, tmp_path, tiny_u2netp):
    """FFA with ``--matting_weights``: the mattes of both CLIs come from the same U^2-Net."""
    report, jreport, adapter = _against_jax(tree, tmp_path, "--metric", "cute", "--weights",
                                            weights["ffa"], "--matting_weights",
                                            weights["u2net"])
    assert isinstance(adapter.scorer.matting, U2NetMatting)
    assert report.correct == jreport.correct


def test_cli_use_mask_with_u2net_matting(tree, weights, tmp_path, tiny_u2netp, capsys):
    """``diffsim --use_mask --matting_weights``: the masks come from U^2-Net saliency at score
    time, and the scores equal the port's scorer on the same images, masks and seed."""
    path = str(tmp_path / "masked.jsonl")
    report, (adapter,) = run_benchmark("cute", _argv(
        tree, "--use_mask", "--matting_weights", weights["u2net"], "--shard", f"0/{SHARDS}",
        "--results", path), device="cpu")
    assert "U^2-Net saliency" in capsys.readouterr().out
    assert adapter.wants_masks and report.total == BATCH
    scores = _scores(f"{path}.s0-{SHARDS}")
    matting = U2NetMatting(store.load_params(weights["u2net"]), device="cpu")
    plan = benchmarks.cute(tree, 2334)[::SHARDS][:BATCH]
    role = {r: [getattr(c, r) for c in plan] for r in "abc"}
    pix = {r: np.concatenate([timage.load_and_process_u8(p, 32) for p in role[r]]) for r in "abc"}
    m = {r: np.concatenate([timage.mask_from_matting(matting, p, 32) for p in role[r]])
         for r in "abc"}
    want = adapter.scorer.score_batch(
        np.concatenate([pix["a"]] * 2), np.concatenate([pix["b"], pix["c"]]),
        prompt=[c.prompt for c in plan] * 2, mask_a=np.concatenate([m["a"]] * 2),
        mask_b=np.concatenate([m["b"], m["c"]]), target_block="up_blocks", target_layer=[0],
        target_step=600, similarity="cosine", seed=2334)
    got = np.array([scores[i] for i in range(BATCH)]).T.reshape(-1)  # [s_ab..., s_ac...]
    np.testing.assert_array_equal(got, want)


def test_cli_ensemble_logs_equal_single_runs_vote_and_resume(tree, tmp_path):
    """``--metric ensemble`` (diffsim, clip_i, dino): the member logs ``.m0``-``.m2`` hold the
    scores of the port's single-metric runs, the report counts the comparisons whose 2-of-3
    majority prefers B, and a rerun scores only what some member's log lacks."""
    ens = str(tmp_path / "ens.jsonl")
    argv = _argv(tree, "--metric", "ensemble", *HALF, "--results", ens)
    report, adapters = run_benchmark("cute", argv, device="cpu")
    assert report.total == N and len(adapters) == 3
    ens += ".s0-2"
    logs = [_scores(f"{ens}.m{i}") for i in range(3)]
    for i, metric in enumerate(("diffsim", "clip_i", "dino")):
        single = str(tmp_path / f"{metric}.jsonl")
        run_benchmark("cute", _argv(tree, "--metric", metric, *HALF, "--results", single),
                      device="cpu")
        want = _scores(f"{single}.s0-2")
        assert sorted(logs[i]) == sorted(want) == list(range(N))
        np.testing.assert_allclose(np.array([logs[i][k] for k in range(N)]),
                                   np.array([want[k] for k in range(N)]), rtol=0, atol=2e-6)
    votes = sum(np.array([[s[k][0] > s[k][1] for k in range(N)] for s in logs]))
    assert report.correct == int((votes >= 2).sum())

    with open(f"{ens}.m1") as f:  # drop the last 5 comparisons from one member's log
        lines = f.readlines()
    with open(f"{ens}.m1", "w") as f:
        f.writelines(lines[:-5])
    dropped = {json.loads(line)["idx"] for line in lines[-5:]}
    again, _ = run_benchmark("cute", argv, device="cpu")
    assert (again.total, again.correct) == (report.total, report.correct)
    for i in range(3):
        with open(f"{ens}.m{i}") as f:
            extra = [json.loads(line)["idx"] for line in f][len(lines) - (5 if i == 1 else 0):]
        assert sorted(extra) == sorted(dropped)  # every member rescored just those


@dataclasses.dataclass
class _Stub:
    """A deterministic ensemble member: scores from the pixels alone, on the pair, triplet or
    path route, blocking or returning a fetch."""

    lower_better: bool
    route: str
    preprocess: object = None
    score_pairs: object = None
    score_triplets: object = None
    score_triplet_paths: object = None

    def __post_init__(self):
        def dist(x, y):
            return np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).mean(
                axis=(1, 2, 3))

        def corr(x, y):
            x = np.asarray(x, np.float64).reshape(len(x), -1)
            y = np.asarray(y, np.float64).reshape(len(y), -1)
            x, y = x - x.mean(1, keepdims=True), y - y.mean(1, keepdims=True)
            return (x * y).sum(1) / np.sqrt((x * x).sum(1) * (y * y).sum(1))

        f = dist if self.lower_better else corr
        if self.route == "pairs":
            self.score_pairs = lambda a, b, prompts, blocking=True: (
                f(a, b) if blocking else (lambda: f(a, b)))
        elif self.route == "triplets":
            self.score_triplets = lambda a, b, c, prompts, blocking=True: (f(a, b), f(a, c))
        else:
            self.score_triplet_paths = lambda pa, pb, pc, a, b, c, prompts, blocking=True: (
                lambda: (f(a, b), f(a, c)))


def _stubs():
    gray = lambda img: np.asarray(img.convert("L").resize((6, 6)), np.float32)[None, ..., None]
    red = lambda img: np.asarray(img.resize((5, 5)), np.uint8)[None, ..., :1]
    return [_Stub(True, "pairs"), _Stub(False, "triplets", gray), _Stub(True, "paths", red)]


def _ensemble(pkg, comparisons, out, lines):
    runner, bench = (trunner, benchmarks) if pkg == "port" else (jrunner, jbenchmarks)
    plan = [bench.Comparison(*c) for c in comparisons]
    report = runner.run_2afc_ensemble(plan, _stubs(), vote_based=plan[0].vote is not None,
                                      img_size=8, batch=4, out_path=out, print_fn=lines.append)
    logs = []
    for m in range(3):
        with open(f"{out}.m{m}") as f:
            logs.append([json.loads(line) for line in f])
    return (report.total, report.correct), logs


@pytest.mark.parametrize("vote_based", [False, True])
def test_run_2afc_ensemble_matches_jax(tmp_path, vote_based):
    """The port's ensemble runner and the JAX one on the same comparisons and stub members (a
    lower-better member on the pair route, a higher-better one on the triplet route, a
    lower-better one on the path route): the same logs, the same report and printout, under
    the CUTE rule and the human-vote rule; then both resume from the same truncated logs."""
    rng = np.random.default_rng(5)
    paths = []
    for k in range(8):
        paths.append(str(tmp_path / f"img{k}.png"))
        Image.fromarray(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)).save(paths[-1])
    comparisons = []
    for i in range(14):
        a, b, c = rng.choice(len(paths), 3, replace=False)
        vote = int(i % 3 == 0) if vote_based else None
        comparisons.append((paths[a], paths[b], paths[c], f"prompt {i}", vote))
    runs = {}
    for pkg in ("port", "jax"):
        lines = []
        runs[pkg] = _ensemble(pkg, comparisons, str(tmp_path / f"{pkg}.jsonl"), lines), lines
    assert runs["port"] == runs["jax"]
    (total, correct), logs = runs["port"][0]
    assert total == 14 and 0 < correct < total
    # every member decides some comparison for B and some for C, and the two rules count
    # differently, so a member's direction or the rule applied shows in the report
    b_wins = [[(r["s_ab"] < r["s_ac"]) == stub.lower_better for r in log]
              for log, stub in zip(logs, _stubs())]
    assert all(0 < sum(w) < len(w) for w in b_wins)
    majority = sum(sum(w) >= 2 for w in zip(*b_wins))
    assert correct != majority if vote_based else correct == majority
    for pkg in ("port", "jax"):  # drop 3 and 6 comparisons from two members' logs
        for m, cut in ((0, 3), (2, 6)):
            path = str(tmp_path / f"{pkg}.jsonl.m{m}")
            with open(path) as f:
                kept = f.readlines()[:-cut]
            with open(path, "w") as f:
                f.writelines(kept)
        lines = []
        runs[pkg] = _ensemble(pkg, comparisons, str(tmp_path / f"{pkg}.jsonl"), lines), lines
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][0] == (total, correct)
    rescored = [[r["idx"] for r in log[14 - cut:]] for log, cut in zip(runs["port"][0][1],
                                                                          (3, 0, 6))]
    assert rescored[0] == rescored[1] == rescored[2] == list(range(8, 14))
