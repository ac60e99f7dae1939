"""The PyTorch port's DiT training and sampling pieces against the JAX package's, on the CPU:
K1's and K2's gradients against their custom VJPs (``_fused_bwd``), K3 and K4 refusing grad, the
Gaussian diffusion (tables, forward process, ``p_mean_variance``, the hybrid loss, DDIM sampling
through a bridged DiT), one ``DiTTrainer.train_step`` against a JAX step assembled from
``vae.encoder_apply``, ``vae.sample_latents``, ``dit.apply``, ``training_losses``,
``jax.value_and_grad``, ``optax.adamw`` and the EMA formula, the bf16 mode against the JAX
step's whole-tree cast and its float32 master state, ``remat``, the checkpoint round trip, the
timestep samplers and ``ImageFolderDataset`` (bit for bit: numpy and PIL in both packages) and
the VAE decoder. Inputs come from numpy
seeds; each tolerance is stated where it is used."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from diffsim_tpu.data import imagefolder as jimagefolder
from diffsim_tpu.models import diffusion as jdiffusion
from diffsim_tpu.models import dit as jdit
from diffsim_tpu.models import vae as jvae
from diffsim_tpu.ops.pallas import attention as pattn
from diffsim_tpu.ops.pallas import ff as pff
from diffsim_tpu.train import timestep_sampler as jsampler
from diffsim_tpu_torch.convert import bridge, store
from diffsim_tpu_torch.data import imagefolder
from diffsim_tpu_torch.models import diffusion, dit
from diffsim_tpu_torch.models.vae import Decoder, VAEConfig
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention
from diffsim_tpu_torch.ops.kernels.attention_stream import streaming_self_attention
from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff
from diffsim_tpu_torch.ops.kernels.readout import cross_self_partials
from diffsim_tpu_torch.train import timestep_sampler
from diffsim_tpu_torch.train.dit_trainer import STATE_FILE, DiTTrainer, TrainConfig

# DiT at DiT-XL/2's head dim (144 / 2 = 72) and 256 tokens (a 32 x 32 latent, patch 2): its
# attention takes K1's route, so under grad it runs through the K1 Function
TINY = dict(input_size=32, patch_size=2, hidden=144, depth=2, heads=2, num_classes=10,
            learn_sigma=True)
IMG = 64  # the tiny VAE halves: 64 px -> the 32 x 32 latent
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _redrawn(tree, seed, scale=0.1):
    """A JAX init tree with every leaf redrawn N(0, scale^2) from ``seed`` (numpy)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(
        treedef, [(rng.standard_normal(np.shape(x)) * scale).astype(np.float32) for x in leaves])


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# the kernels under grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2, 256, 72), (2, 1, 256, 40)])
def test_k1_gradient_matches_the_jax_custom_vjp(shape):
    """Through the Function, the port of ``_fused_bwd`` within 1e-5 (float32 products in
    another order); the bf16_probs forward has the exact backward, as in JAX."""
    q, k, v, g = (_rand(shape, seed) for seed in range(4))
    ref = pattn._fused_bwd(None, False, tuple(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(g))
    grads = {}
    for fast in (False, True):
        qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fused_self_attention(*qkv, fast)
        assert type(out.grad_fn).__name__ == "FusedSelfAttentionBackward"
        grads[fast] = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for ours, theirs in zip(grads[False], ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-5)
    for exact, fast in zip(grads[False], grads[True]):
        torch.testing.assert_close(fast, exact, rtol=0, atol=0)
    with torch.no_grad():  # without grad the path is the plain call, no Function
        assert fused_self_attention(*(torch.from_numpy(a) for a in (q, k, v))).grad_fn is None


def test_k2_gradient_matches_the_jax_custom_vjp():
    """Through the Function, the port of ``ff._fused_bwd`` (the nn.Linear weight layout)
    within 1e-5 relative and absolute (float32 sums over the 64 rows in another order)."""
    n, c = 64, 32
    x, g = _rand((n, c), 0), _rand((n, c), 1)
    w1, b1 = _rand((c, 8 * c), 2, 0.2), _rand((8 * c,), 3, 0.1)
    w2, b2 = _rand((4 * c, c), 4, 0.2), _rand((c,), 5, 0.1)
    ref = pff._fused_bwd(None, tuple(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                         jnp.asarray(g))
    ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
           for a in (x, w1.T, b1, w2.T, b2)]
    out = fused_geglu_ff(*ins)
    assert type(out.grad_fn).__name__ == "FusedGegluFFBackward"
    dx, dw1, db1, dw2, db2 = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for ours, theirs in zip((dx, dw1.T, db1, dw2.T, db2), ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


def test_k3_and_k4_refuse_grad():
    """The TPU kernels define no VJP: under grad, on inputs that require it, the wrappers
    raise instead of returning a detached result; without grad they run."""
    rows = [torch.from_numpy(_rand((2, 64, 8), seed)) for seed in range(5)]
    with pytest.raises(RuntimeError, match="no backward"):
        cross_self_partials(rows[0].requires_grad_(), *rows[1:])
    with torch.no_grad():
        assert cross_self_partials(*rows)[0].shape == (2,)
    qkv = [torch.from_numpy(_rand((1, 1, 64, 192), seed)).requires_grad_() for seed in range(3)]
    with pytest.raises(RuntimeError, match="no backward"):
        streaming_self_attention(*qkv)
    with torch.no_grad():
        assert streaming_self_attention(*qkv).shape == (1, 1, 64, 192)


# ---------------------------------------------------------------------------
# the Gaussian diffusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("respacing", ["", "250", "ddim50"])
def test_diffusion_tables_match_jax(respacing):
    """The float64 host tables, bit for bit (the same numpy arithmetic)."""
    ours = diffusion.create_diffusion(respacing)
    ref = jdiffusion.create_diffusion(respacing)
    np.testing.assert_array_equal(ours.betas, ref.betas)
    np.testing.assert_array_equal(ours.timestep_map, ref.timestep_map)
    assert ours.num_steps == ref.num_steps
    for name, table in ref._tables().items():
        np.testing.assert_array_equal(ours.tables[name], table)


def _model_fns(c):
    """One deterministic eps / variance model in both layouts: eps = 0.3 x + 1e-3 model_t,
    variance channels tanh(x)."""

    def jax_fn(x, model_t):
        return jnp.concatenate([0.3 * x + 1e-3 * model_t[:, None, None, None], jnp.tanh(x)], -1)

    def torch_fn(x, model_t):
        return torch.cat([0.3 * x + 1e-3 * model_t[:, None, None, None], torch.tanh(x)], 1)

    return jax_fn, torch_fn


@pytest.mark.parametrize("respacing", ["", "250"])
def test_diffusion_functions_match_jax(respacing):
    """q_sample, q_posterior, p_mean_variance (LEARNED_RANGE, clipped and not) and the hybrid
    training loss, t = 0 (the NLL branch) included, within 1e-5 absolute and relative: float32
    arithmetic in both, constants rounded in another order."""
    ours, ref = diffusion.create_diffusion(respacing), jdiffusion.create_diffusion(respacing)
    n = ours.num_steps
    t = np.array([0, 1, n // 2, n - 1])
    x0 = np.clip(_rand((4, 8, 8, 4), 10), -1, 1)
    xt, noise = _rand((4, 8, 8, 4), 11), _rand((4, 8, 8, 4), 12)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    jax_fn, torch_fn = _model_fns(4)

    def close(a, b):
        np.testing.assert_allclose(_nhwc(a) if a.dim() == 4 else a.detach().numpy(),
                                   np.asarray(b), rtol=1e-5, atol=1e-5)

    close(ours.q_sample(_nchw(x0), tt, _nchw(noise)),
          ref.q_sample(jnp.asarray(x0), jt, jnp.asarray(noise)))
    (mean, log_var), (ref_mean, ref_log_var) = (
        ours.q_posterior(_nchw(x0), _nchw(xt), tt),
        ref.q_posterior(jnp.asarray(x0), jnp.asarray(xt), jt))
    close(mean, ref_mean)
    close(log_var.reshape(-1), jnp.reshape(ref_log_var, -1))
    for clip in (True, False):
        mine = ours.p_mean_variance(torch_fn, _nchw(xt), tt, clip)
        theirs = ref.p_mean_variance(jax_fn, jnp.asarray(xt), jt, clip)
        for key in ("mean", "log_var", "x0", "eps"):
            close(mine[key], theirs[key])
    mine = ours.training_losses(torch_fn, _nchw(x0), tt, _nchw(noise))
    theirs = ref.training_losses(jax_fn, jnp.asarray(x0), jt, jnp.asarray(noise))
    for key in ("mse", "vb", "loss"):
        close(mine[key], theirs[key])


def test_ddim_sampling_through_a_bridged_dit_matches_jax():
    """``ddim_sample_loop`` (eta 0, ten DDIM steps, CFG-free) from one initial noise through
    the same tiny DiT, within 1e-4: deterministic in both, the gap float32 rounding carried
    through ten DiT forwards, with the timestep embedding's 1-ulp ``exp`` difference (ROADMAP
    Queue 3) amplified by t up to 900."""
    cfg = dict(input_size=8, num_classes=10, learn_sigma=True)
    tree = _redrawn(jdit.init(jax.random.PRNGKey(0), jdit.DiTConfig.tiny(**cfg)), 7)
    model = bridge.load(_meta(lambda: dit.DiT(dit.DiTConfig.tiny(**cfg))), tree, "dit", "cpu",
                        torch.float32).eval()
    noise = _rand((2, 8, 8, 4), 8)
    labels = np.array([3, 10])
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jdiffusion.create_diffusion("ddim10").ddim_sample_loop(
        lambda x, mt: jdit.apply(jtree, x, mt, jnp.asarray(labels), jdit.DiTConfig.tiny(**cfg))[0],
        noise.shape, jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    with torch.no_grad():
        out = diffusion.create_diffusion("ddim10").ddim_sample_loop(
            lambda x, mt: model(x, mt, torch.from_numpy(labels))[0], (2, 4, 8, 8), None,
            noise=_nchw(noise))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=0, atol=1e-4)


def _meta(factory):
    with torch.device("meta"):
        return factory()


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    """The tiny DiT and the tiny VAE encoder as seeded numpy trees in the JAX layout."""
    return {"dit": _redrawn(jdit.init(jax.random.PRNGKey(1), jdit.DiTConfig(**TINY)), 1),
            "vae": _redrawn(jvae.encoder_init(jax.random.PRNGKey(2), jvae.VAEConfig.tiny()), 2)}


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(5)
    return dict(pixels=rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8),
                labels=np.array([4, 7]),
                latent_noise=rng.standard_normal((BATCH, 32, 32, 4)).astype(np.float32),
                noise=rng.standard_normal((BATCH, 32, 32, 4)).astype(np.float32),
                t=np.array([0, 617]), drop=np.array([False, True]))


def _trainer(trees, **cfg):
    trainer = DiTTrainer(TrainConfig(image_size=IMG, **cfg), dit_cfg=dit.DiTConfig(**TINY),
                         vae_cfg=VAEConfig.tiny(), vae_params=trees["vae"], device="cpu")
    trainer.load_params(trees["dit"])
    return trainer


def _step(trainer, inputs):
    pixels, labels = inputs["pixels"], inputs["labels"]
    rest = {k: v for k, v in inputs.items() if k not in ("pixels", "labels")}
    return trainer.train_step(pixels, labels, **rest)


def _jax_step(trees, inputs, compute_dtype=None):
    """The JAX trainer's step assembled from its parts, on the injected draws. With
    ``compute_dtype`` the model runs as the JAX trainer's mixed precision runs it
    (``diffsim_tpu/train/dit_trainer.py``, ``loss_fn``): every floating parameter and the
    latents cast to that dtype, the output cast back to float32."""
    cfg, d = jdit.DiTConfig(**TINY), jdiffusion.create_diffusion(None)
    pixels = jnp.asarray(inputs["pixels"]).astype(jnp.float32) / 127.5 - 1.0
    moments = jvae.encoder_apply(trees["vae"], pixels)
    latents = jvae.sample_latents(moments, None, 0.18215, noise=jnp.asarray(inputs["latent_noise"]))
    labels = jnp.where(jnp.asarray(inputs["drop"]), cfg.num_classes, jnp.asarray(inputs["labels"]))
    t = jnp.asarray(inputs["t"])

    def loss_fn(params):
        if compute_dtype is not None:
            params = jax.tree_util.tree_map(
                lambda a: a.astype(compute_dtype) if jnp.issubdtype(a.dtype, jnp.floating)
                else a, params)

        def model_fn(x, mt):
            if compute_dtype is not None:
                x = x.astype(compute_dtype)
            return jdit.apply(params, x, mt, labels, cfg)[0].astype(jnp.float32)

        losses = d.training_losses(model_fn, latents, t, jnp.asarray(inputs["noise"]))
        return jnp.mean(losses["loss"] * jnp.ones(BATCH)), losses

    params = jax.tree_util.tree_map(jnp.asarray, trees["dit"])
    (loss, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"loss": float(loss), "mse": float(jnp.mean(losses["mse"])), "grads": grads,
            "before": trees["dit"]}


def _flat(state) -> dict:
    return store._flatten(bridge.to_jax_tree(state, "dit"))


@pytest.fixture(scope="module", params=[(5, 617), (999, 3)])
def stepped(request, trees, step_inputs):
    inputs = {**step_inputs, "t": np.array(request.param)}
    trainer = _trainer(trees)
    metrics = _step(trainer, inputs)
    return trainer, metrics, _jax_step(trees, inputs)


def test_train_step_matches_jax(stepped):
    """One float32 step against the JAX step on the same weights and draws. The loss and the
    MSE within 2e-5 relative. Each gradient leaf within 1e-4 of its largest entry: the port's
    attention backward is the K1 Function's, the JAX one XLA's autodiff, and the timestep
    embedding's 1-ulp frequencies (ROADMAP Queue 3) reach every adaLN gradient. The parameters
    within 1e-7 of ``optax.adamw``'s update of the port's own gradients (rounding of weights of
    size ~0.5): the first Adam step is g / (|g| + eps) times the learning rate, so a gradient
    entry near zero whose sign differs by rounding between the packages would move its weight
    by up to 2e-4 either way, and the optimizer is held apart from the gradients. The EMA
    within 1e-7 of the JAX formula on the same two parameter sets. (t = 0 is held apart:
    :func:`test_t0_vb_term_differs_only_where_float32_cannot_resolve_it`.)"""
    trainer, metrics, ref = stepped
    assert trainer.step == 1
    np.testing.assert_allclose(metrics["loss"], ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(metrics["mse"], ref["mse"], rtol=2e-5)
    grads = _flat({n: p.grad for n, p in trainer.model.named_parameters()})
    ref_grads = store._flatten(jax.device_get(ref["grads"]))
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        scale = np.abs(ref_grads[name]).max()
        np.testing.assert_allclose(g, ref_grads[name], rtol=0, atol=1e-4 * scale, err_msg=name)
    before = jax.tree_util.tree_map(jnp.asarray, ref["before"])
    opt = optax.adamw(1e-4, weight_decay=0.0)
    jgrads = jax.tree_util.tree_map(jnp.asarray, bridge.to_jax_tree(
        {n: p.grad for n, p in trainer.model.named_parameters()}, "dit"))

    @jax.jit
    def adamw_and_ema(grads, params):
        updates, _ = opt.update(grads, opt.init(params), params)
        new = optax.apply_updates(params, updates)
        return new, jax.tree_util.tree_map(lambda e, p: e * 0.9999 + p * (1 - 0.9999), params, new)

    want, want_ema = adamw_and_ema(jgrads, before)
    for ours, theirs in ((trainer.model, want), (trainer.ema, want_ema)):
        flat, flat_ref = _flat(ours.state_dict()), store._flatten(jax.device_get(theirs))
        for name, a in flat.items():
            np.testing.assert_allclose(a, flat_ref[name], rtol=0, atol=1e-7, err_msg=name)


def test_t0_vb_term_differs_only_where_float32_cannot_resolve_it():
    """At t = 0 the VB term is the discretized Gaussian NLL, log(Phi(+) - Phi(-)) of two CDF
    values that, at t = 0's small variance, both sit within a few float32 ulps of 1 for most
    latents (the edge bins' single tail within a few ulps of 0 in 1 + tanh). There the difference is rounding: XLA's CPU tanh is off by up to 2.8e-7 near 1,
    torch's by 3e-8, so the packages clamp at 1e-12 or not on different elements, and a
    train step at t = 0 differs in its loss by ~0.2 %. Wherever the float64 probability p of the
    bin is at least 1e-5 the two agree within the log's response to the tanh errors, 4e-7 / p
    (two CDFs, each half of 1 + tanh off by at most 2.8e-7 + 3e-8), plus 1e-5."""
    d = diffusion.create_diffusion(None)
    x = np.clip(_rand((2, 16, 16, 4), 20, 0.6), -1.2, 1.2)
    means = x + _rand((2, 16, 16, 4), 21, 0.05)
    log_scales = np.full_like(x, 0.5 * d.tables["post_log_var_clipped"][0], dtype=np.float32)
    ours = diffusion._discretized_gaussian_log_likelihood(
        *(torch.from_numpy(a) for a in (x, means, log_scales))).numpy()
    ref = np.asarray(jdiffusion._discretized_gaussian_log_likelihood(
        *(jnp.asarray(a) for a in (x, means, log_scales))))

    def cdf(z):
        return 0.5 * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (z + 0.044715 * z**3)))

    c, inv = x.astype(np.float64) - means, np.exp(-log_scales.astype(np.float64))
    plus, minus = cdf(inv * (c + 1 / 255)), cdf(inv * (c - 1 / 255))
    # the edge bins take one tail, Phi(+) or 1 - Phi(-), with the same cancellation in 1 + tanh
    prob = np.where(x < -0.999, plus, np.where(x > 0.999, 1 - minus, plus - minus))
    resolved = prob >= 1e-5
    assert resolved.mean() > 0.2 and (~resolved).any()
    bound = 4e-7 / prob[resolved] + 1e-5
    assert (np.abs(ours[resolved] - ref[resolved]) <= bound).all()


def test_train_step_routes_the_attention_through_the_k1_function(trees, step_inputs,
                                                                 monkeypatch):
    """Each DiT block's attention (256 tokens, head dim 72) goes through the Function: one
    forward per block and step, one backward per block."""
    from diffsim_tpu_torch.ops.kernels import attention as k1

    calls = {"forward": 0, "backward": 0}
    fwd, bwd = k1.FusedSelfAttention.forward, k1.fused_self_attention_bwd_plain

    def counting_forward(ctx, *args):
        calls["forward"] += 1
        return fwd(ctx, *args)

    def counting_backward(*args):
        calls["backward"] += 1
        return bwd(*args)

    monkeypatch.setattr(k1.FusedSelfAttention, "forward", staticmethod(counting_forward))
    monkeypatch.setattr(k1, "fused_self_attention_bwd_plain", counting_backward)
    _step(_trainer(trees), step_inputs)
    assert calls == {"forward": TINY["depth"], "backward": TINY["depth"]}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_remat_equals_no_remat(trees, step_inputs, compute_dtype):
    """Recomputing each block in the backward changes no number: loss, gradients and the
    updated parameters bit for bit, in float32 and in the bf16 mode."""
    runs = []
    for remat in (False, True):
        trainer = _trainer(trees, remat=remat, compute_dtype=compute_dtype)
        metrics = _step(trainer, step_inputs)
        runs.append((metrics, {n: (p.detach().clone(), p.grad.clone())
                               for n, p in trainer.model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for name, (p, g) in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][name][0], p, rtol=0, atol=0)
        torch.testing.assert_close(runs[1][1][name][1], g, rtol=0, atol=0)


def test_bf16_mode_keeps_the_master_state_in_float32(trees, step_inputs):
    """``compute_dtype="bfloat16"``: the weights, their gradients, the AdamW moments and the EMA
    stay float32, the loss is finite and near the float32 step's (within 5e-2 relative: bf16
    keeps 8 bits), and the weights move."""
    trainer = _trainer(trees, compute_dtype="bfloat16")
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    metrics = _step(trainer, step_inputs)
    f32 = _step(_trainer(trees), step_inputs)
    assert np.isfinite(metrics["loss"])
    np.testing.assert_allclose(metrics["loss"], f32["loss"], rtol=5e-2)
    for name, p in trainer.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert not torch.equal(p, before[name]), name
    assert all(p.dtype == torch.float32 for p in trainer.ema.parameters())
    for state in trainer.optimizer.state.values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32


def test_bf16_step_matches_the_jax_whole_tree_cast(trees, step_inputs):
    """The bf16 mode against the JAX trainer's bf16 step (every floating parameter and the
    latents cast to bfloat16, the output cast to float32) on the same weights and draws. The
    two round at different places (torch rounds every op's result to bf16; XLA's CPU compiler
    keeps float32 through its fusions), so they agree at bf16 scale only: the loss and the MSE
    within 1e-2 relative (measured 3.9e-3), each gradient leaf within 8e-2 of its largest
    entry (measured at most 4.0e-2), the same size as the JAX bf16 step's own distance from
    its float32 step."""
    inputs = {**step_inputs, "t": np.array([5, 617])}
    trainer = _trainer(trees, compute_dtype="bfloat16")
    metrics = _step(trainer, inputs)
    ref = _jax_step(trees, inputs, jnp.bfloat16)
    np.testing.assert_allclose(metrics["loss"], ref["loss"], rtol=1e-2)
    np.testing.assert_allclose(metrics["mse"], ref["mse"], rtol=1e-2)
    grads = _flat({n: p.grad for n, p in trainer.model.named_parameters()})
    ref_grads = store._flatten(jax.device_get(ref["grads"]))
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        assert g.dtype == ref_grads[name].dtype == np.float32, name
        scale = np.abs(ref_grads[name]).max()
        np.testing.assert_allclose(g, ref_grads[name], rtol=0, atol=8e-2 * scale, err_msg=name)


def test_checkpoint_round_trip_continues_the_step_count(trees, step_inputs, tmp_path):
    """A restored trainer holds the saved step, weights, EMA and AdamW state, and its next step
    equals the original's bit for bit; a directory without the port's state file (an orbax
    checkpoint of the JAX package) raises, naming the .npz route."""
    first = _trainer(trees)
    _step(first, step_inputs)
    first.save(str(tmp_path / "ckpt"))
    assert os.path.exists(tmp_path / "ckpt" / STATE_FILE)
    second = DiTTrainer(TrainConfig(image_size=IMG, seed=9), dit_cfg=dit.DiTConfig(**TINY),
                        vae_cfg=VAEConfig.tiny(), vae_params=trees["vae"], device="cpu")
    second.restore(str(tmp_path / "ckpt"))
    assert second.step == 1
    a, b = _step(first, step_inputs), _step(second, step_inputs)
    assert a == b and first.step == second.step == 2
    for (name, p), q in zip(first.model.named_parameters(), second.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)
    for e, f in zip(first.ema.parameters(), second.ema.parameters()):
        torch.testing.assert_close(f, e, rtol=0, atol=0)
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match=r"\.npz"):
        second.restore(str(tmp_path / "orbax"))


def test_uninjected_steps_repeat_from_the_seed(trees, step_inputs):
    """Without injected draws, t comes from numpy seeded (seed, 0), as the JAX trainer's first
    process draws it, and the VAE, noise and dropout draws from a generator seeded by
    (seed, step): two trainers of one seed take the same steps."""
    runs = [_step(_trainer(trees), {"pixels": step_inputs["pixels"],
                                    "labels": step_inputs["labels"]}) for _ in range(2)]
    assert runs[0] == runs[1] and np.isfinite(runs[0]["loss"])
    ref = jsampler.UniformSampler(1000).sample(np.random.default_rng((0, 0)), BATCH)
    ours = timestep_sampler.UniformSampler(1000).sample(np.random.default_rng((0, 0)), BATCH)
    np.testing.assert_array_equal(ours[0], ref[0])


def test_steps_update_a_loss_aware_timestep_sampler(trees, step_inputs):
    """A sampler passed to the trainer draws each step's t and takes its per-example losses."""
    sampler = timestep_sampler.LossSecondMomentSampler(1000, history=2)
    trainer = DiTTrainer(TrainConfig(image_size=IMG), dit_cfg=dit.DiTConfig(**TINY),
                         vae_cfg=VAEConfig.tiny(), vae_params=trees["vae"],
                         timestep_sampler=sampler, device="cpu")
    _step(trainer, {"pixels": step_inputs["pixels"], "labels": step_inputs["labels"]})
    assert sampler._counts.sum() == BATCH and np.count_nonzero(sampler._losses) == BATCH


def test_sampling_with_guidance_and_decoder(trees):
    """``sample`` with CFG, ancestral and DDIM, on the EMA weights: NHWC latents, or images
    through a decoder; finite, and repeatable from the generator's seed."""
    trainer = _trainer(trees)
    decoder = trainer.build_decoder(
        _redrawn(jvae.decoder_init(jax.random.PRNGKey(3), jvae.VAEConfig.tiny()), 3))
    for ddim in (False, True):
        outs = [trainer.sample(np.array([1, 10]), torch.Generator().manual_seed(4),
                               cfg_scale=4.0, num_steps=3, ddim=ddim) for _ in range(2)]
        assert outs[0].shape == (2, 32, 32, 4) and np.isfinite(outs[0]).all()
        np.testing.assert_array_equal(outs[0], outs[1])
    img = trainer.sample(np.array([2]), torch.Generator().manual_seed(4), num_steps=2,
                         vae_decoder=decoder)
    assert img.shape == (1, IMG, IMG, 3) and np.isfinite(img).all()


# ---------------------------------------------------------------------------
# host modules, bit for bit
# ---------------------------------------------------------------------------


def test_timestep_samplers_match_jax():
    ours, ref = timestep_sampler.UniformSampler(50), jsampler.UniformSampler(50)
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        for x, y in zip(ours.sample(a, 7), ref.sample(b, 7)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    ours = timestep_sampler.LossSecondMomentSampler(20, history=2)
    ref = jsampler.LossSecondMomentSampler(20, history=2)
    a, b, losses = np.random.default_rng(2), np.random.default_rng(2), np.random.default_rng(3)
    for _ in range(12):  # through the warm-up into importance sampling
        (t, w), (tr, wr) = ours.sample(a, 8), ref.sample(b, 8)
        np.testing.assert_array_equal(t, tr)
        np.testing.assert_array_equal(w, wr)
        values = losses.random(8)
        ours.update(t, values)
        ref.update(tr, values)
        np.testing.assert_array_equal(ours.weights(), ref.weights())
    assert ours.warmed_up and ref.warmed_up


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(6)
    for c, name in enumerate(("cat", "dog")):
        os.makedirs(root / name)
        for i in range(5):
            h, w = (40, 52) if i % 2 else (70, 33)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                root / name / f"{i}.jpg" if i % 3 else root / name / f"{i}.png")
    return str(root)


def test_imagefolder_batches_match_jax(image_tree):
    """The classes, the centre crop and two epochs of shuffled, flipped batches equal to the JAX
    package's; the two halves of a two-process run equal the halves of the JAX package's whole
    batches, flips included (each process draws the whole batch's flips and keeps its own, so
    N processes step on one process's batch; the JAX copy's processes draw flips for their own
    slice alone)."""
    ours = imagefolder.ImageFolderDataset(image_tree, 16, seed=3)
    ref = jimagefolder.ImageFolderDataset(image_tree, 16, seed=3)
    assert ours.classes == ref.classes and ours.samples == ref.samples
    for _ in range(2):
        got = list(ours.epoch_batches(4))
        want = list(ref.epoch_batches(4))
        assert len(got) == len(want) == 2
        for (p, l), (pr, lr) in zip(got, want):
            np.testing.assert_array_equal(p, pr)
            np.testing.assert_array_equal(l, lr)
            assert p.dtype == np.uint8 and l.dtype == lr.dtype
    whole = list(jimagefolder.ImageFolderDataset(image_tree, 16, seed=1).epoch_batches(4))
    for proc in range(2):
        got = list(imagefolder.ImageFolderDataset(image_tree, 16, seed=1).epoch_batches(
            4, process_slice=(proc, 2)))
        assert len(got) == len(whole) == 2
        for (p, l), (pr, lr) in zip(got, whole):
            np.testing.assert_array_equal(p, pr[2 * proc:2 * proc + 2])
            np.testing.assert_array_equal(l, lr[2 * proc:2 * proc + 2])
    with Image.open(ours.samples[0][0]) as img:
        np.testing.assert_array_equal(imagefolder.center_crop_arr(img, 12),
                                      jimagefolder.center_crop_arr(img, 12))


# ---------------------------------------------------------------------------
# the VAE decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [VAEConfig.tiny(), dataclasses.replace(
    VAEConfig.tiny(), block_out_channels=(32, 64, 64), layers_per_block=2)])
def test_vae_decoder_matches_jax(cfg):
    """The decoder within 1e-5 of ``decoder_apply`` on the same tree (two up blocks and three),
    and the bridge's ``vae_decoder`` kind round-trips the tree."""
    jcfg = jvae.VAEConfig(**dataclasses.asdict(cfg))
    tree = _redrawn(jvae.decoder_init(jax.random.PRNGKey(4), jcfg), 4)
    z = _rand((2, 8, 8, 4), 9)
    ref = jvae.decoder_apply(tree, jnp.asarray(z), jcfg)
    module = bridge.load(_meta(lambda: Decoder(cfg)), tree, "vae_decoder", "cpu", torch.float32)
    with torch.no_grad():
        out = module(_nchw(z))
    assert out.shape == (2, 3, 8 * cfg.downscale, 8 * cfg.downscale)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=0, atol=1e-5)
    back = store._flatten(bridge.to_jax_tree(module.state_dict(), "vae_decoder"))
    flat = store._flatten(jax.device_get(tree))
    assert sorted(back) == sorted(flat)
    for name, leaf in flat.items():
        np.testing.assert_array_equal(back[name], leaf)
