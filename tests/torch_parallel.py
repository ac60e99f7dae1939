"""Run the port's data-parallel paths on the ranks of a gloo process group on the CPU.

:func:`run` spawns ``size`` processes (``torch.multiprocessing``, the spawn method), joins them
into one group over a ``file://`` store, calls one of the scenario functions below on every rank
and returns each rank's result; a rank that raises fails the call. The scenarios import torch
and the port only (no JAX), so a spawned rank starts in a few seconds; the tests compare their
results with the JAX package and with one-rank runs in the test process."""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pickle
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=120)  # a rank stuck in a collective fails the test


def _entry(rank, fn, size, root, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=size, timeout=TIMEOUT)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run(fn, size: int, root, *args) -> list:
    """``fn(*args)`` on each rank of a ``size``-rank gloo group; the ranks' results in order.
    ``root`` is a fresh directory for the store and the results."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    mp.start_processes(_entry, args=(fn, size, root, args), nprocs=size, join=True,
                       start_method="spawn")
    out = []
    for rank in range(size):
        with open(os.path.join(root, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def tiny_args(metric: str, *extra):
    from diffsim_tpu_torch.cli.args import arg_parse

    return arg_parse(["--metric", metric, "--model_scale", "tiny", "--image_size", "32",
                      "--target_layer", "0", "--target_step", "600", "--similarity", "cosine",
                      *extra])


def score_calls(adapter, pix, paths) -> dict:
    """One adapter's pair, triplet and cached-triplet calls on 8, 3 and 1 rows: with 1 row on
    two ranks, rank 1 scores nothing and still joins the gather."""
    out = {}
    for n in (8, 3, 1):
        a, b, c = (p[:n] for p in pix)
        prompts = ["a photo"] * n
        out[f"pairs{n}"] = adapter.score_pairs(a, b, prompts)
        out[f"triplets{n}"] = adapter.score_triplets(a, b, c, prompts)
        fetch = adapter.score_triplet_paths(*(p[:n] for p in paths), prompts=prompts,
                                            blocking=False)
        out[f"paths{n}"] = fetch()
    return out


def scoring(sd15_params, inputs, pix, paths, cli_argv, results, rank_argv, serve_pairs):
    """Every scoring path on this rank: the bridged SD-1.5 scorer's ``score_batch`` with
    injected noise, the tiny SD-1.5 and DiT adapters' calls (:func:`score_calls`), the ``cute``
    CLI (``results`` holds a partial log to resume), ``retrieval rank``, one service round (rank
    0 serves, rank 1 follows), the kernel build barrier and a weight mismatch."""
    from diffsim_tpu_torch.cli import retrieval, serve
    from diffsim_tpu_torch.cli.main import run_benchmark
    from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
    from diffsim_tpu_torch.metrics.registry import build_metric, over_ranks
    from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
    from diffsim_tpu_torch.models.unet import UNetConfig
    from diffsim_tpu_torch.models.vae import VAEConfig
    from diffsim_tpu_torch.ops.kernels import build
    from diffsim_tpu_torch.parallel import mesh

    rank = dist.get_rank()
    out = {}
    scorer = DiffSimSD15(sd15_params, unet_cfg=UNetConfig.tiny(),
                         vae_cfg=VAEConfig.tiny(), text_cfg=CLIPTextConfig.tiny(), img_size=32,
                         dtype=torch.float32, device="cpu")
    sharded = over_ranks(scorer.score_batch)
    out["bridged"] = sharded(*inputs["pix"], prompt=inputs["prompts"],
                             noise_override=inputs["noise"], target_block="up_blocks",
                             target_layer=(0,), target_step=600, similarity="cosine")
    out["bridged_rows"] = sharded.rows

    for metric in ("diffsim", "dit"):
        adapter = build_metric(tiny_args(metric), "cpu")
        out[metric] = score_calls(adapter, pix, paths)
        out[f"{metric}_rows"] = {k: getattr(adapter, k).rows
                                 for k in ("score_pairs", "score_triplets", "score_triplet_paths")}
        out[f"{metric}_misses"] = adapter.scorer._moment_cache.stats["misses"]

    report, (adapter,) = run_benchmark("cute", cli_argv + ["--results", results], device="cpu")
    out["cli"] = (report.total, report.correct, report.correct_2x,
                  adapter.score_triplet_paths.rows)

    retrieval.rank(rank_argv, device="cpu")

    args = tiny_args("diffsim", "--batch_size", "4")
    serve.IDLE_S = 0.2  # keep-alives while the leader waits for the request
    if rank == 0:
        server, batcher = serve.make_server(args, 0, max_wait_ms=50.0, device="cpu")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        threading.Event().wait(0.5)  # idle: a few keep-alives reach the follower
        body = json.dumps({"pairs": serve_pairs, "prompt": "a photo"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/score",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out["served"] = json.loads(r.read())["scores"]
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        batcher.close()
    else:
        out["follower_rows"] = serve.follow(args, device="cpu").score_pairs.rows

    built = []

    def slow_build(names=build.SOURCES):
        time.sleep(0.5)
        built.append(list(names))

    real = build.build
    build.build = slow_build
    t0 = time.monotonic()
    try:
        build.build_on_local_leader()  # LOCAL_RANK unset: the rank is the local rank
    finally:
        build.build = real
    out["built"] = (built, time.monotonic() - t0)

    mismatched = torch.nn.Linear(4, 4)
    torch.nn.init.constant_(mismatched.weight, float(rank))
    try:
        mesh.check_same_weights(mismatched, "a module")
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


def serve_follower_fails(port: int) -> dict:
    """``serve.main`` on both ranks, rank 1's scorer raising in the first round: rank 0 serves
    one request on ``port`` and must end with an error, not serve on. Each rank's outcome."""
    from diffsim_tpu_torch.cli import serve
    from diffsim_tpu_torch.metrics import registry

    argv = ["--port", str(port), "--metric", "diffsim", "--model_scale", "tiny",
            "--image_size", "32", "--target_layer", "0", "--target_step", "600",
            "--similarity", "cosine", "--batch_size", "2"]
    out = {}
    if dist.get_rank() == 1:
        real = registry.build_metric

        def failing(args, device=None):
            def score_pairs(*a, **kw):
                raise RuntimeError("the follower's scorer failed")

            return dataclasses.replace(real(args, device), score_pairs=score_pairs)

        registry.build_metric = failing
    else:
        def client():
            url = f"http://127.0.0.1:{port}"
            for _ in range(600):
                try:
                    urllib.request.urlopen(url + "/healthz", timeout=5).close()
                    break
                except OSError:
                    time.sleep(0.1)
            rng = np.random.default_rng(0)
            pair = [{"b64": _png_b64(rng)}, {"b64": _png_b64(rng)}]
            req = urllib.request.Request(url + "/score", headers={
                "Content-Type": "application/json"},
                data=json.dumps({"pairs": [pair, pair]}).encode())
            try:
                urllib.request.urlopen(req, timeout=60).close()
                out["status"] = 200
            except urllib.error.HTTPError as e:
                out["status"] = e.code

        thread = threading.Thread(target=client, daemon=True)
        thread.start()
    def serving():
        try:
            serve.main(argv, device="cpu")
            out["error"] = None
        except Exception as e:  # what would end the process with a non-zero exit
            out["error"] = f"{type(e).__name__}: {e}"

    t0 = time.monotonic()
    main = threading.Thread(target=serving, daemon=True)  # a service that serves on is left
    main.start()
    main.join(timeout=90)
    out["seconds"] = time.monotonic() - t0
    if main.is_alive():
        out["error"] = "still serving"
    if dist.get_rank() == 0:
        thread.join(timeout=60)
    return out


def _png_b64(rng) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


# ---------------------------------------------------------------------------
# training and sampling
# ---------------------------------------------------------------------------


def training(trees, tiny, img, steps, ckpt_dir, cli_argv, sample_argv):
    """The DiT trainer on this rank's block of each global batch: one step with injected draws
    (its loss and summed gradients), then a checkpoint written by rank 0 and restored on every
    rank, DDIM and ancestral sampling; steps with the trainer's own draws in float32 and bf16;
    then ``dit_train --distributed`` and ``dit_sample``."""
    from diffsim_tpu_torch.cli import dit_sample
    from diffsim_tpu_torch.parallel import mesh

    out = {}
    rows = mesh.shard_rows(len(steps[0]["labels"]))
    for name, cfg, inject in (("injected", {}, True), ("drawn", {}, False),
                              ("bf16", {"compute_dtype": "bfloat16"}, False)):
        t = dit_trainer(trees, tiny, img, **cfg)
        out[name] = train_steps(t, steps[:1] if inject else steps, rows, inject)
        if inject:
            t.save(ckpt_dir)
            restored = dit_trainer(trees, tiny, img, seed=9)
            restored.restore(ckpt_dir)
            out["restored"] = {"step": restored.step, "params": state(restored.model)}
            out["samples"] = sample_both(t)
    out["cli"] = train_cli(cli_argv)
    dit_sample.main(sample_argv, device="cpu")
    return out


def train_cli(argv) -> dict:
    """``dit_train.main(argv)`` on the CPU: its step count, weights and each step's loss."""
    from diffsim_tpu_torch.cli import dit_train
    from diffsim_tpu_torch.train.dit_trainer import DiTTrainer

    losses, step = [], DiTTrainer.train_step

    def recording(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        losses.append(out["loss"])
        return out

    DiTTrainer.train_step = recording
    try:
        trainer = dit_train.main(argv, device="cpu")
    finally:
        DiTTrainer.train_step = step
    return {"step": trainer.step, "params": state(trainer.model), "losses": losses}


def dit_trainer(trees, tiny, img, **cfg):
    from diffsim_tpu_torch.models import dit
    from diffsim_tpu_torch.models.vae import VAEConfig
    from diffsim_tpu_torch.train.dit_trainer import DiTTrainer, TrainConfig

    t = DiTTrainer(TrainConfig(image_size=img, **cfg), dit_cfg=dit.DiTConfig(**tiny),
                   vae_cfg=VAEConfig.tiny(), vae_params=trees["vae"], device="cpu")
    t.load_params(trees["dit"])
    return t


def state(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def train_steps(trainer, steps, rows, inject: bool) -> dict:
    """``trainer`` stepped on ``rows`` of each global batch in ``steps``, with the injected
    draws or its own; the metrics, the last step's gradients, the weights and the EMA."""
    metrics = []
    for step in steps:
        draws = {k: v for k, v in step.items() if k not in ("pixels", "labels")}
        metrics.append(trainer.train_step(step["pixels"][rows], step["labels"][rows],
                                          **(draws if inject else {})))
    return {"metrics": metrics, "step": trainer.step, "params": state(trainer.model),
            "ema": state(trainer.ema),
            "grads": {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()}}


def sample_both(trainer) -> dict:
    """DDIM then ancestral sampling of 3 labels at CFG 4.0, 3 steps, one generator."""
    gen = torch.Generator().manual_seed(4)
    labels = np.array([1, 10, 3])
    return {"ddim": trainer.sample(labels, gen, cfg_scale=4.0, num_steps=3, ddim=True),
            "ancestral": trainer.sample(labels, gen, cfg_scale=4.0, num_steps=3)}
