"""The port's DiT training and sampling over a process group on the CPU: two ranks over gloo
(``tests/torch_parallel.py`` spawns them once for this module), each stepping on its block of
the global batch and taking every draw at the global batch, against one rank in the test process
at the same global batch and against the JAX step on a mesh of two devices.

Tolerances: the loss within 2e-5 relative and each gradient leaf within 1e-4 of its largest
entry against JAX, as the one-card step test holds them (tests/test_torch_port_train.py). Two
ranks against one differ only in the order of float32 sums (each rank's GEMMs have half the
rows): the loss within 1e-5 relative and each gradient leaf within 1e-5 of its largest entry
(measured 7e-8 and 9e-7); in the bf16 mode, where every op rounds to 8 bits (2^-9 relative),
within 1e-3 and 2e-2 (measured 3.6e-5 and 8.1e-3). AdamW's first steps move each weight by about
the learning rate, g / (|g| + eps) times 1e-4, so a gradient entry near zero whose sign rounds
differently moves its weight the other way: weights after n steps are held within 2 n 1e-4
(measured at most 1.7e-4 after 2). Samples: the draws are the same numbers, and a 1e-7
difference in the model's eps reaches x0 times sqrt(1 / alpha_bar - 1), about 158 at t = 999,
and up to 2 x 4 - 1 = 7 through the guidance at CFG 4: 1.1e-4 on samples of size 1 (measured
1.13e-4 with DDIM, 4.5e-5 ancestral), held within 5e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from PIL import Image

from diffsim_tpu.models import diffusion as jdiffusion
from diffsim_tpu.models import dit as jdit
from diffsim_tpu.models import vae as jvae
from diffsim_tpu.parallel import mesh as jmesh
from diffsim_tpu_torch.cli import dit_sample
from diffsim_tpu_torch.convert import bridge, store
from tests import torch_parallel

# the tiny DiT of tests/test_torch_port_train.py: head dim 72 at 256 tokens takes K1's route
TINY = dict(input_size=32, patch_size=2, hidden=144, depth=2, heads=2, num_classes=10,
            learn_sigma=True)
IMG = 64
BATCH = 4  # the global batch: 2 a rank
LR = 1e-4
SIZE = 16  # the CLIs' tiny scale (tests/test_torch_port_train_cli.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redrawn(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(
        treedef, [(rng.standard_normal(np.shape(x)) * scale).astype(np.float32) for x in leaves])


def _steps():
    rng = np.random.default_rng(5)
    return [dict(pixels=rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8),
                 labels=rng.integers(0, 10, BATCH),
                 latent_noise=rng.standard_normal((BATCH, 32, 32, 4)).astype(np.float32),
                 noise=rng.standard_normal((BATCH, 32, 32, 4)).astype(np.float32),
                 t=np.array(t), drop=np.array([False, True, False, False]))
            for t in ([5, 617, 999, 300], [40, 2, 700, 123])]


def _jax_step_on_mesh(trees, step):
    """The JAX trainer's step, assembled from its parts as tests/test_torch_port_train.py does,
    with the batch sharded over a mesh of 2 devices (``kernel_jit``, ``P("data")``)."""
    cfg, d = jdit.DiTConfig(**TINY), jdiffusion.create_diffusion(None)
    mesh = jmesh.make_mesh(2)
    ds, rs = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())

    def loss_fn(params, pixels, latent_noise, noise, labels, drop, t):
        moments = jvae.encoder_apply(trees["vae"], pixels.astype(jnp.float32) / 127.5 - 1.0)
        latents = jvae.sample_latents(moments, None, 0.18215, noise=latent_noise)
        labels = jnp.where(drop, cfg.num_classes, labels)

        def model_fn(x, mt):
            return jdit.apply(params, x, mt, labels, cfg)[0]

        losses = d.training_losses(model_fn, latents, t, noise)
        return jnp.mean(losses["loss"]), losses

    fn = jmesh.kernel_jit(jax.value_and_grad(loss_fn, has_aux=True), mesh,
                          in_shardings=(rs,) + (ds,) * 6)
    params = jax.tree_util.tree_map(jnp.asarray, trees["dit"])
    (loss, _), grads = fn(params, *(jnp.asarray(step[k]) for k in (
        "pixels", "latent_noise", "noise", "labels", "drop", "t")))
    return float(loss), store._flatten(jax.device_get(grads))


def _flat(state) -> dict:
    return store._flatten(bridge.to_jax_tree(state, "dit"))


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_images")
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        os.makedirs(root / name)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)).save(
                root / name / f"{i}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data_path):
    root = tmp_path_factory.mktemp("parallel_train")
    trees = {"dit": _redrawn(jdit.init(jax.random.PRNGKey(1), jdit.DiTConfig(**TINY)), 1),
             "vae": _redrawn(jvae.encoder_init(jax.random.PRNGKey(2), jvae.VAEConfig.tiny()), 2)}
    steps = _steps()
    one = {}
    for name, cfg, inject in (("injected", {}, True), ("drawn", {}, False),
                              ("bf16", {"compute_dtype": "bfloat16"}, False)):
        t = torch_parallel.dit_trainer(trees, TINY, IMG, **cfg)
        one[name] = torch_parallel.train_steps(t, steps[:1] if inject else steps, slice(None),
                                               inject)
        if inject:
            one["samples"] = torch_parallel.sample_both(t)

    def cli(results, *extra):
        return ["--data_path", data_path, "--results_dir", str(results), "--model_scale",
                "tiny", "--image_size", str(SIZE), "--global_batch_size", "4", "--log_every",
                "1", "--ckpt_every", "2", "--max_steps", "2", *extra]

    def sample(out):
        return ["--ckpt", str(root / "one" / "ckpt_0000002"), "--model_scale", "tiny",
                "--image_size", str(SIZE), "--num_classes", "10", "--class_labels", "1", "2",
                "3", "4", "5", "--num_sampling_steps", "3", "--out", str(out)]

    one["cli"] = torch_parallel.train_cli(cli(root / "one"))
    dit_sample.main(sample(root / "one.png"), device="cpu")
    two = torch_parallel.run(torch_parallel.training, 2, root / "spawn", trees, TINY, IMG, steps,
                             str(root / "ckpt"), cli(root / "two", "--distributed"),
                             sample(root / "two.png"))
    return {"one": one, "two": two, "trees": trees, "steps": steps, "root": root}


def _close_weights(ours, theirs, steps):
    """Weights after ``steps`` AdamW steps, each within 2 steps lr: a gradient entry near zero
    (the key projection's bias has none but rounding) that rounds to the other sign moves its
    weight the other way. The losses, compared beside, tell the data and the draws apart."""
    for name, a in ours.items():
        np.testing.assert_allclose(a, theirs[name], rtol=0, atol=2 * steps * LR, err_msg=name)


def _close_grads(ours, theirs, frac):
    assert sorted(ours) == sorted(theirs)
    for name, g in ours.items():
        scale = np.abs(theirs[name]).max()
        np.testing.assert_allclose(g, theirs[name], rtol=0, atol=frac * scale, err_msg=name)


def test_two_rank_step_matches_the_jax_step_on_a_mesh_of_two(runs):
    """One step with injected draws, 2 rows a rank: the loss of the global batch and its
    gradients, summed over the ranks, against the JAX step with the batch sharded over a mesh
    of 2; every rank holds the same loss and gradients."""
    loss, grads = _jax_step_on_mesh(runs["trees"], runs["steps"][0])
    r0, r1 = (r["injected"] for r in runs["two"])
    assert r0["metrics"] == r1["metrics"] and r0["step"] == r1["step"] == 1
    np.testing.assert_allclose(r0["metrics"][0]["loss"], loss, rtol=2e-5)
    _close_grads(_flat(r0["grads"]), grads, 1e-4)
    for name, g in r0["grads"].items():
        np.testing.assert_array_equal(r1["grads"][name], g, err_msg=name)


@pytest.mark.parametrize("mode", ["injected", "drawn", "bf16"])
def test_two_rank_steps_equal_one_rank_steps(runs, mode):
    """Steps at the same global batch on two ranks and on one: with injected draws, with the
    trainer's own draws (each rank draws t, the VAE and diffusion noise and the label drop at
    the global batch and keeps its rows) and in the bf16 mode. The losses, the last gradients,
    the weights and the EMA agree; the two ranks' weights and EMA are equal."""
    one = runs["one"][mode]
    r0, r1 = (r[mode] for r in runs["two"])
    assert r0["step"] == r1["step"] == one["step"]
    loss_rtol, grad_frac = (1e-3, 2e-2) if mode == "bf16" else (1e-5, 1e-5)
    for ours, theirs in zip(r0["metrics"], one["metrics"]):
        for k in ("loss", "mse"):
            np.testing.assert_allclose(ours[k], theirs[k], rtol=loss_rtol)
    _close_grads(r0["grads"], one["grads"], grad_frac)
    for key in ("params", "ema"):
        for name, a in r0[key].items():
            np.testing.assert_array_equal(r1[key][name], a, err_msg=name)
        _close_weights(r0[key], one[key], one["step"])


def test_rank_zero_checkpoint_restores_on_every_rank(runs):
    """``save`` on two ranks: rank 0 writes the one checkpoint; both ranks restore its step
    and weights."""
    ckpt = runs["root"] / "ckpt"
    assert os.listdir(ckpt) == ["trainer_state.pt"]
    for r in runs["two"]:
        assert r["restored"]["step"] == 1
        for name, a in r["injected"]["params"].items():
            np.testing.assert_array_equal(r["restored"]["params"][name], a, err_msg=name)


@pytest.mark.parametrize("sampler", ["ddim", "ancestral"])
def test_two_rank_sampling_equals_one_rank(runs, sampler):
    """3 labels sampled 2 + 1 over the ranks with CFG, each rank drawing the initial noise and
    every step's noise at the whole batch's shape: both ranks return all 3 samples, equal to one
    rank's within 5e-4 (the module's docstring says why)."""
    one = runs["one"]["samples"][sampler]
    a, b = (r["samples"][sampler] for r in runs["two"])
    np.testing.assert_array_equal(a, b)
    assert a.shape == one.shape == (3, 32, 32, 4)
    np.testing.assert_allclose(a, one, rtol=0, atol=5e-4)


def test_dit_train_distributed_and_dit_sample_on_two_ranks(runs):
    """``dit_train --distributed`` on two ranks (2 images a rank of each global batch of 4,
    flips included) takes the one-rank run's steps; rank 0 writes its log and checkpoints.
    ``dit_sample`` on two ranks writes the one-rank grid."""
    root, one = runs["root"], runs["one"]["cli"]
    for r in runs["two"]:
        assert r["cli"]["step"] == one["step"] == 2
        np.testing.assert_allclose(r["cli"]["losses"], one["losses"], rtol=1e-5)
        _close_weights(r["cli"]["params"], one["params"], 2)
    assert sorted(os.listdir(root / "two")) == ["ckpt_0000002", "log.txt"]
    log = open(root / "two" / "log.txt").read()
    assert "(step=0000002) train loss:" in log
    with Image.open(root / "one.png") as a, Image.open(root / "two.png") as b:
        np.testing.assert_allclose(np.asarray(b, np.int16), np.asarray(a, np.int16), atol=1)

