"""The PyTorch port's models (diffsim_tpu_torch/models) against the JAX package's on the same
weights and inputs, in float32 on the CPU, at rtol = atol = 1e-4.

UNet and VAE weights are the committed torch fixture (tests/fixtures/torch_parity_tiny.npz)
converted by the JAX package's converters and handed to the port through its bridge; the text
tower takes a JAX init tree with redrawn leaves."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.convert.diffusion_import import convert_sd_unet, convert_vae
from diffsim_tpu.models import clip_text as jclip
from diffsim_tpu.models import unet as junet
from diffsim_tpu.models import vae as jvae
from diffsim_tpu.ops.taps import QKV as JQKV
from diffsim_tpu.ops.taps import TapSpec as JTapSpec
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
from diffsim_tpu_torch.metrics.scorer_base import build_module
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig, sample_latents
from diffsim_tpu_torch.ops.taps import QKV, TapSpec

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_parity_tiny.npz")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(factory, tree, kind):
    return build_module(factory, tree, kind, torch.device("cpu"), torch.float32, None)


@pytest.fixture(scope="module")
def fix():
    d = np.load(FIXTURE)
    sds = {"unet": {}, "vae": {}}
    for key in d.files:
        if key.startswith("sd::"):
            _, which, name = key.split("::", 2)
            sds[which][name] = d[key]
    utree = jax.device_get(convert_sd_unet(sds["unet"], junet.UNetConfig.tiny(), strict=True))
    enc, _ = convert_vae(sds["vae"], jvae.VAEConfig.tiny(), strict=True)
    return d, utree, jax.device_get(enc)


@pytest.fixture(scope="module")
def port_unet(fix):
    return _port(lambda: UNet(UNetConfig.tiny()), fix[1], "unet")


def test_clip_text_matches_jax():
    cfg = jclip.CLIPTextConfig.tiny()
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(
        jax.device_get(jclip.init(jax.random.PRNGKey(0), cfg, jnp.float32)))
    tree = jax.tree_util.tree_unflatten(
        treedef, [(rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32) for x in leaves])
    ids = HashTokenizer(cfg.vocab_size)(["", "a photo of a dog", "The photo of a cat"])
    ref = jclip.apply(tree, jnp.asarray(ids), cfg)["last_hidden_state"]
    model = _port(lambda: CLIPText(CLIPTextConfig.tiny()), tree, "text")
    out = model(torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_vae_moments_match_jax_and_the_torch_fixture(fix):
    d, _, enc = fix
    pixels = d["pixels"]  # (2, 3, 32, 32) NCHW
    ref = jvae.encoder_apply(enc, jnp.asarray(pixels.transpose(0, 2, 3, 1)))
    model = _port(lambda: Encoder(VAEConfig.tiny()), enc, "vae")
    out = model(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(out.transpose(0, 2, 3, 1), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out, d["vae_moments"], **TOL)


@pytest.mark.parametrize("mode", [False, True])
def test_sample_latents_matches_jax(fix, mode):
    moments = fix[0]["vae_moments"]  # (2, 8, 16, 16)
    moments = moments.copy()
    moments[:, 4:] *= 40.0  # push logvar past both clamp bounds
    noise = np.random.default_rng(1).standard_normal((2, 4, 16, 16)).astype(np.float32)
    ref = jvae.sample_latents(jnp.asarray(moments.transpose(0, 2, 3, 1)), None, 0.18215,
                              noise=jnp.asarray(noise.transpose(0, 2, 3, 1)), mode=mode)
    out = sample_latents(torch.from_numpy(moments), 0.18215, noise=torch.from_numpy(noise),
                         mode=mode)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref), **TOL)


def test_unet_eps_matches_jax_and_the_torch_fixture(fix, port_unet):
    d, utree, _ = fix
    x, t, ctx = d["latents"], float(d["model_t"]), d["context"]
    ref, _ = junet.apply(utree, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.float32(t),
                         jnp.asarray(ctx), junet.UNetConfig.tiny())
    eps, taps = port_unet(torch.from_numpy(x), t, torch.from_numpy(ctx))
    assert taps == {}
    np.testing.assert_allclose(eps.numpy().transpose(0, 2, 3, 1), np.asarray(ref), **TOL)
    np.testing.assert_allclose(eps.numpy(), d["eps"], **TOL)


SITES = [("up", (1, -1, -1)), ("down", (0, -1, -1)), ("mid", (0, -1, -1))]


@pytest.mark.parametrize("block,address", SITES)
@pytest.mark.parametrize("attn", ["attn1", "attn2"])
def test_unet_qkv_taps_match_jax(fix, port_unet, block, address, attn):
    d, utree, _ = fix
    x = np.concatenate([d["latents"], d["latents"][:, ::-1]])
    t, ctx = 401.0, np.concatenate([d["context"], d["context"] * 0.5])
    ref_eps, ref = junet.apply(utree, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.float32(t),
                               jnp.asarray(ctx), junet.UNetConfig.tiny(),
                               tap=JTapSpec(block, address, attn, JQKV))
    tap = TapSpec(block, address, attn, QKV)
    none, early = port_unet(torch.from_numpy(x), t, torch.from_numpy(ctx), tap=tap)
    assert none is None
    for name in ("q", "k", "v"):
        np.testing.assert_allclose(early[name].numpy(), np.asarray(ref[name]), **TOL)
    eps, full = port_unet(torch.from_numpy(x), t, torch.from_numpy(ctx), tap=tap,
                          stop_at_tap=False)
    np.testing.assert_allclose(eps.numpy().transpose(0, 2, 3, 1), np.asarray(ref_eps), **TOL)
    for name in ("q", "k", "v"):  # the early exit changes nothing up to the tap
        np.testing.assert_array_equal(early[name].numpy(), full[name].numpy())


def test_unet_tap_matches_the_torch_fixture(fix, port_unet):
    d = fix[0]
    _, taps = port_unet(torch.from_numpy(d["latents"]), float(d["model_t"]),
                        torch.from_numpy(d["context"]), tap=TapSpec("up", (1, -1, -1), "attn1", QKV))
    for name in ("q", "k", "v"):
        np.testing.assert_allclose(taps[name].numpy(), d[f"tap_{name}"], **TOL)
