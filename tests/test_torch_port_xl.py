"""The PyTorch port's SDXL scorer (diffsim_tpu_torch/metrics/diffsim_xl.py) and its modules
against the JAX package's, in float32 on the CPU with injected noise (``noise_override``), so
both frameworks see the same draws: the Euler noise spec, a bigG-shaped text tower, the XL UNet's
eps and taps, the chunked VAE encode, the scorer at 32 px and at 128 px (where the tap has 1024
tokens, so the port's readout takes K3's plain version), and the committed torch fixture's XL
score grid. Scores agree within 5e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.convert.diffusion_import import convert_sd_unet, convert_vae
from diffsim_tpu.core import schedulers as jsched
from diffsim_tpu.metrics.diffsim_xl import DiffSimXL as JaxDiffSimXL
from diffsim_tpu.metrics.diffsim_xl import sdxl_tap as jax_tap
from diffsim_tpu.models import clip_text as jclip
from diffsim_tpu.models import unet as junet
from diffsim_tpu.models import vae as jvae
from diffsim_tpu_torch.core import schedulers
from diffsim_tpu_torch.core.tokenizer import CLIPTokenizer, HashTokenizer
from diffsim_tpu_torch.metrics.diffsim_xl import DiffSimXL, sdxl_tap
from diffsim_tpu_torch.metrics.scorer_base import build_module
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig, default_chunk, encode_chunked

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_parity_xl_dit.npz")
ATOL = 5e-5
TOL = dict(rtol=1e-4, atol=1e-4)
# the tiny tower-2 shape of tests/test_torch_parity_xl_dit.py: bigG's structure (gelu, a
# bias-free text projection) at width 32; both towers concatenate to the UNet's 64-wide context
TEXT2 = dict(vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64, act="gelu",
             projection_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redrawn(tree, seed):
    """A JAX init tree with every leaf redrawn N(0, 0.1) from ``seed`` (numpy)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(
        treedef, [(rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32) for x in leaves])


def _split_state_dict(d, prefix):
    return {k[len(prefix):]: d[k] for k in d.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def fix():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def params(fix):
    """The fixture's XL UNet and VAE through the JAX converters, plus redrawn text towers."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {
        "unet": jax.device_get(convert_sd_unet(_split_state_dict(fix, "xl::unet::"),
                                               junet.UNetConfig.tiny_xl(64), strict=True)),
        "vae": jax.device_get(convert_vae(_split_state_dict(fix, "vae::"), jvae.VAEConfig.tiny(),
                                          strict=True)[0]),
        "text": _redrawn(jclip.init(k1, jclip.CLIPTextConfig.tiny(), jnp.float32), 1),
        "text2": _redrawn(jclip.init(k2, jclip.CLIPTextConfig(**TEXT2), jnp.float32), 2),
    }


def _port(params, img_size=32, **kw):
    return DiffSimXL(params, unet_cfg=UNetConfig.tiny_xl(64), vae_cfg=VAEConfig.tiny(),
                     text_cfg=CLIPTextConfig.tiny(), text2_cfg=CLIPTextConfig(**TEXT2),
                     img_size=img_size, dtype=torch.float32, device="cpu", **kw)


def _jax(params, img_size=32, **kw):
    return JaxDiffSimXL(params, unet_cfg=junet.UNetConfig.tiny_xl(64),
                        vae_cfg=jvae.VAEConfig.tiny(), text_cfg=jclip.CLIPTextConfig.tiny(),
                        text2_cfg=jclip.CLIPTextConfig(**TEXT2), img_size=img_size,
                        dtype=jnp.float32, **kw)


@pytest.mark.parametrize("step", [0, 1, 100, 600, 900, 999])
def test_sdxl_noise_spec_matches_jax(step):
    ours, ref = schedulers.sdxl_noise_spec(step), jsched.sdxl_noise_spec(step)
    assert (ours.model_t, ours.a, ours.b) == (ref.model_t, ref.a, ref.b)
    assert schedulers.euler_init_noise_sigma() == jsched.euler_init_noise_sigma()


def test_big_g_shaped_text_tower_matches_jax():
    """gelu, the bias-free text projection of the EOS-pooled state, and the pre-final-LN hidden
    states (SDXL conditions on the penultimate one)."""
    cfg = dict(TEXT2, layers=3)
    tree = _redrawn(jclip.init(jax.random.PRNGKey(4), jclip.CLIPTextConfig(**cfg), jnp.float32), 4)
    ids = HashTokenizer(1000)(["", "a photo of a dog", "The photo of a cat"])
    ref = jclip.apply(tree, jnp.asarray(ids), jclip.CLIPTextConfig(**cfg),
                      output_hidden_states=True)
    model = build_module(lambda: CLIPText(CLIPTextConfig(**cfg)), tree, "text2",
                         torch.device("cpu"), torch.float32, None)
    out = model.encode(torch.from_numpy(ids.astype(np.int64)), output_hidden_states=True)
    for key in ("last_hidden_state", "pooled", "text_embeds"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL)
    assert len(out["hidden_states"]) == len(ref["hidden_states"]) == 4
    for ours, theirs in zip(out["hidden_states"], ref["hidden_states"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


XL_SITES = [("up", (0, 1, 1)), ("up", (0, 0, 0)), ("mid", (0, 0, 1)), ("down", (1, 0, 1))]


@pytest.mark.parametrize("block,address", XL_SITES)
def test_xl_unet_eps_and_taps_match_jax(params, block, address):
    """The linear-projection transformers, the text_time addition embedding and 3-index taps;
    the early exit changes nothing up to the tap."""
    from diffsim_tpu.ops.taps import TapSpec as JTapSpec
    from diffsim_tpu_torch.ops.taps import TapSpec

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((3, 77, 64)).astype(np.float32)
    pooled = rng.standard_normal((3, 16)).astype(np.float32)
    time_ids = np.tile(DiffSimXL.default_time_ids(), (3, 1))
    ref_eps, ref = junet.apply(
        params["unet"], jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.float32(100.0), jnp.asarray(ctx),
        junet.UNetConfig.tiny_xl(64), tap=JTapSpec(block, address),
        added_cond={"text_embeds": jnp.asarray(pooled), "time_ids": jnp.asarray(time_ids)})
    model = build_module(lambda: UNet(UNetConfig.tiny_xl(64)), params["unet"], "unet",
                         torch.device("cpu"), torch.float32, None)
    added = {"text_embeds": torch.from_numpy(pooled), "time_ids": torch.from_numpy(time_ids)}
    tap = TapSpec(block, address)
    eps, full = model(torch.from_numpy(x), 100.0, torch.from_numpy(ctx), tap=tap,
                      stop_at_tap=False, added_cond=added)
    none, early = model(torch.from_numpy(x), 100.0, torch.from_numpy(ctx), tap=tap,
                        added_cond=added)
    assert none is None
    np.testing.assert_allclose(eps.numpy().transpose(0, 2, 3, 1), np.asarray(ref_eps), **TOL)
    for name in ("q", "k", "v"):
        np.testing.assert_allclose(full[name].numpy(), np.asarray(ref[name]), **TOL)
        np.testing.assert_array_equal(early[name].numpy(), full[name].numpy())


def test_xl_unet_matches_the_torch_fixture(fix, params):
    model = build_module(lambda: UNet(UNetConfig.tiny_xl(64)), params["unet"], "unet",
                         torch.device("cpu"), torch.float32, None)
    added = {"text_embeds": torch.from_numpy(fix["xl_pooled"][1:2]),
             "time_ids": torch.from_numpy(DiffSimXL.default_time_ids()[None])}
    eps, taps = model(torch.from_numpy(fix["xl_latents"]), schedulers.sdxl_noise_spec(900).model_t,
                      torch.from_numpy(fix["xl_embeds"][1:2]), tap=sdxl_tap("up_blocks", (0, 1, 1)),
                      stop_at_tap=False, added_cond=added)
    np.testing.assert_allclose(eps.numpy(), fix["xl_eps"], **TOL)
    for name in ("q", "k", "v"):
        np.testing.assert_allclose(taps[name].numpy(), fix[f"xl_tap_{name}"], **TOL)


@pytest.mark.parametrize("chunk", [None, 2])
def test_chunked_encode_matches_jax(params, chunk):
    """Five images in slices of two (two slices and a remainder) or, by default, at once."""
    pix = np.random.default_rng(6).uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    ref = jvae.encoder_apply_chunked(params["vae"], jnp.asarray(pix), chunk)
    model = build_module(lambda: Encoder(VAEConfig.tiny()), params["vae"], "vae",
                         torch.device("cpu"), torch.float32, None)
    out = encode_chunked(model, torch.from_numpy(pix.transpose(0, 3, 1, 2).copy()), chunk)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref), **TOL)


def test_default_chunk_is_the_jax_formula():
    """2 images at 1024 px in float32 (the SDXL path), 16 at 512 px in bf16."""
    assert default_chunk(torch.empty((6, 3, 1024, 1024), device="meta")) == 2
    assert default_chunk(torch.empty((6, 3, 512, 512), dtype=torch.bfloat16, device="meta")) == 16
    assert VAEConfig.sdxl().scaling_factor == jvae.VAEConfig.sdxl().scaling_factor == 0.13025


@pytest.mark.parametrize("size", [32, 128])
@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_score_batch_matches_jax(params, size, similarity):
    rng = np.random.default_rng(size)
    a, b = (rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32) for _ in range(2))
    noise = tuple(rng.standard_normal((2, size // 2, size // 2, 4)).astype(np.float32)
                  for _ in range(2))
    kw = dict(prompt=["a photo of a cat", "a dog"], target_block="up_blocks",
              target_layer=(0, 1, 1), target_step=900, similarity=similarity,
              noise_override=noise)
    ref = _jax(params, size).score_batch(a, b, **kw)
    out = _port(params, size).score_batch(a, b, **kw)
    assert out.shape == (2,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("block,layer,step", [("down_blocks", (0, 0, 1), 600),
                                              ("mid_blocks", (0, 1), 300)])
def test_score_batch_matches_jax_at_other_taps_without_cfg_parity(params, block, layer, step):
    """uint8 pixels, other tap sites and steps, and the cond-only batch (cfg_parity=False)."""
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8) for _ in range(2))
    noise = tuple(rng.standard_normal((2, 16, 16, 4)).astype(np.float32) for _ in range(2))
    kw = dict(prompt="x", target_block=block, target_layer=layer, target_step=step,
              noise_override=noise)
    ref = _jax(params, cfg_parity=False).score_batch(a, b, **kw)
    out = _port(params, cfg_parity=False).score_batch(a, b, **kw)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def fixture_scorer(fix, params):
    scorer = _port(params)
    # the fixture's embeds/pooled stand in for the two towers' outputs (uncond rows zeroed)
    scorer._prompt_cache[""] = (torch.from_numpy(fix["xl_embeds"].astype(np.float32)),
                                torch.from_numpy(fix["xl_pooled"].astype(np.float32)))
    return scorer


XL_GRID = [(site, step, sim)
           for site in (("up011", "up_blocks", (0, 1, 1)),
                        ("mid01", "mid_blocks", (0, 1)),
                        ("down001", "down_blocks", (0, 0, 1)))
           for step in (900, 600)
           for sim in ("cosine", "mse")]


@pytest.mark.parametrize("site,step,sim", XL_GRID)
def test_score_grid_matches_the_torch_fixture(fix, fixture_scorer, site, step, sim):
    """The 64-pair XL grid of tests/fixtures/torch_parity_xl_dit.npz, held as the JAX package
    holds it (tests/test_torch_parity_xl_dit.py)."""
    name, target_block, target_layer = site
    pix = fix["xl_pair_pixels"].transpose(0, 1, 3, 4, 2)
    noise = (fix["xl_eps_vae"][:, 0].transpose(0, 2, 3, 1),
             fix["xl_eps_noise"][:, 0].transpose(0, 2, 3, 1))
    scores = fixture_scorer.score_batch(
        pix[:, 0], pix[:, 1], prompt="", target_block=target_block, target_layer=target_layer,
        target_step=step, similarity=sim, noise_override=noise)
    np.testing.assert_allclose(scores, fix[f"xl_grid::{name}::{step}::{sim}"], rtol=5e-4,
                               atol=ATOL)


@pytest.mark.parametrize("cfg_parity", [True, False])
@pytest.mark.parametrize("chunk", [None, 2])
def test_triplet_batch_equals_two_score_batches(params, cfg_parity, chunk):
    scorer = _port(params, cfg_parity=cfg_parity)
    rng = np.random.default_rng(8)
    a, b, c = (rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8) for _ in range(3))
    kw = dict(prompt="a dog", target_layer=(0, 1, 1), target_step=900, seed=2334)
    s_ab, s_ac = scorer.score_triplet_batch(a, b, c, chunk=chunk, **kw)
    np.testing.assert_allclose(s_ab, scorer.score_batch(a, b, **kw), atol=1e-6)
    np.testing.assert_allclose(s_ac, scorer.score_batch(a, c, **kw), atol=1e-6)


def test_diffsim_score_on_image_paths(params, tmp_path):
    from PIL import Image

    from diffsim_tpu_torch.core.image import load_and_process

    rng = np.random.default_rng(9)
    paths = []
    for i in range(2):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    scorer = _port(params)
    out = scorer.diffsim_score(paths[0], paths[1], seed=11)
    want = scorer.score_batch(load_and_process(paths[0], 32), load_and_process(paths[1], 32),
                              seed=11)
    assert isinstance(out, float) and out == float(want[0])


def test_tap_translation_matches_jax():
    for args in [("up_blocks", (0, 1, 1)), ("up_blocks", [1, 2, 9]), ("down_blocks", (1, 0, 1)),
                 ("mid_blocks", (0, 3)), ("mid_blocks", 0)]:
        ours, ref = sdxl_tap(*args), jax_tap(*args)
        assert (ours.block, tuple(ours.address), ours.attn, ours.capture) == \
            (ref.block, tuple(ref.address), ref.attn, ref.capture)
    with pytest.raises(ValueError, match="3 indices"):
        sdxl_tap("up_blocks", (0, 1))


def test_uncond_half_is_zero_and_pooled_comes_from_tower_2(params):
    scorer = _port(params)
    embeds, pooled = scorer.encode_prompt("a photo of a cat")
    assert embeds.shape == (2, 77, 64) and pooled.shape == (2, 16)
    assert not embeds[0].any() and not pooled[0].any()
    ids = torch.from_numpy(scorer.tokenizer2(["a photo of a cat"]).astype(np.int64))
    np.testing.assert_array_equal(pooled[1:].numpy(),
                                  scorer.text2.encode(ids)["text_embeds"].numpy())


def test_tokenizer2_pads_with_exclamation_mark(params):
    vocab = {"!": 0, "a</w>": 1, "<|startoftext|>": 2, "<|endoftext|>": 3}
    scorer = _port(params, tokenizer=CLIPTokenizer(vocab, []))
    assert scorer.tokenizer.pad_id == 3 and scorer.tokenizer2.pad_id == 0


def test_parts_outside_this_slice_raise(params):
    """The IP-Adapter is ported (tests/test_torch_port_ip.py), and so are the CLIP metrics'
    vision taps that its encoder once left to them."""
    import dataclasses

    from diffsim_tpu_torch.models.clip_vision import CLIPVisionConfig
    from diffsim_tpu_torch.models.ip_adapter import ResamplerConfig

    scorer = _port(params)
    scorer.enable_ip_adapter(encoder_cfg=CLIPVisionConfig.tiny(),
                             resampler_cfg=dataclasses.replace(ResamplerConfig.tiny(),
                                                               output_dim=64))
    a = np.zeros((1, 32, 32, 3), np.uint8)
    assert np.isfinite(scorer.score_batch(a, a, ip_adapter=True)).all()
    with torch.no_grad():  # the CLIP metrics' taps run on the IP-Adapter's encoder too
        taps = scorer.ip_encoder.tap(torch.zeros(1, 3, 32, 32), 0)
    assert sorted(taps) == ["k", "q", "v"]


def test_partial_weight_trees_are_refused(params):
    with pytest.raises(ValueError, match="exactly"):
        _port({k: v for k, v in params.items() if k != "text2"})


def test_scorer_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffSimXL()
