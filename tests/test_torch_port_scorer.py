"""The PyTorch port's SD-1.5 DiffSim scorer against the JAX scorer and the committed torch
fixture, in float32 on the CPU with injected noise (``noise_override``), so both frameworks see
the same draws. Scores agree within 5e-5."""

import os

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
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15, sd15_tap
from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNetConfig
from diffsim_tpu_torch.models.vae import VAEConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_parity_tiny.npz")
ATOL = 5e-5
P = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fix():
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
    params = {
        "unet": jax.device_get(convert_sd_unet(sds["unet"], junet.UNetConfig.tiny(), strict=True)),
        "vae": jax.device_get(convert_vae(sds["vae"], jvae.VAEConfig.tiny(), strict=True)[0]),
        "text": text,
    }
    return d, params


def _port(params, **kw):
    return DiffSimSD15(params, unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny(),
                       text_cfg=CLIPTextConfig.tiny(), img_size=32, dtype=torch.float32,
                       device="cpu", **kw)


def _jax(params, **kw):
    return JaxDiffSim(params, unet_cfg=junet.UNetConfig.tiny(), vae_cfg=jvae.VAEConfig.tiny(),
                      text_cfg=jclip.CLIPTextConfig.tiny(), img_size=32, dtype=jnp.float32, **kw)


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        a, b = (rng.integers(0, 256, (P, 32, 32, 3), dtype=np.uint8) for _ in range(2))
    else:
        a, b = (rng.uniform(-1, 1, (P, 32, 32, 3)).astype(np.float32) for _ in range(2))
    noise = tuple(rng.standard_normal((2, 16, 16, 4)).astype(np.float32) for _ in range(2))
    return a, b, noise


@pytest.mark.parametrize("cfg_parity", [True, False])
@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_score_batch_matches_jax(fix, cfg_parity, similarity):
    params = fix[1]
    a, b, noise = _inputs(1)
    prompts = ["a photo of a dog", "a cat"] * (P // 2)
    kw = dict(prompt=prompts, target_block="up_blocks", target_layer=(0,), target_step=600,
              similarity=similarity, noise_override=noise)
    ref = _jax(params, cfg_parity=cfg_parity).score_batch(a, b, **kw)
    out = _port(params, cfg_parity=cfg_parity).score_batch(a, b, **kw)
    assert out.shape == (P,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("block,layer,step", [("down_blocks", 0, 150), ("mid_blocks", 0, 600),
                                              ("up_blocks", [1], 600)])
def test_score_batch_matches_jax_at_other_taps(fix, block, layer, step):
    """uint8 pixels (mapped to [-1, 1] on the device), the layer-collapse quirk and other
    tap sites and steps."""
    params = fix[1]
    a, b, noise = _inputs(2, np.uint8)
    kw = dict(prompt="x", target_block=block, target_layer=layer, target_step=step,
              noise_override=noise)
    ref = _jax(params).score_batch(a, b, **kw)
    out = _port(params).score_batch(a, b, **kw)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def fixture_scorer(fix):
    d, params = fix
    scorer = _port(params)
    # the fixture's context stands in for the CLIP text embeds
    scorer._prompt_cache[""] = torch.from_numpy(d["pair_embeds"].astype(np.float32))
    return scorer


GRID = [(block, step, sim)
        for block in ("up", "down", "mid")
        for step in (600, 150)
        for sim in ("cosine", "mse")]


@pytest.mark.parametrize("block,step,sim", GRID)
def test_score_grid_matches_the_torch_fixture(fix, fixture_scorer, block, step, sim):
    """The 64-pair grid of tests/fixtures/torch_parity_tiny.npz within 5e-5 (the JAX package
    holds it at rtol 5e-4 on top, tests/test_torch_parity_tiny.py)."""
    d = fix[0]
    pix = d["pair_pixels"].transpose(0, 1, 3, 4, 2)
    noise = (d["pair_eps_vae"][:, 0].transpose(0, 2, 3, 1),
             d["pair_eps_noise"][:, 0].transpose(0, 2, 3, 1))
    scores = fixture_scorer.score_batch(
        pix[:, 0], pix[:, 1], prompt="", target_block=f"{block}_blocks", target_layer=(0,),
        target_step=step, similarity=sim, noise_override=noise)
    np.testing.assert_allclose(scores, d[f"grid::{block}::{step}::{sim}"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("cfg_parity", [True, False])
@pytest.mark.parametrize("chunk", [None, 2])
def test_triplet_batch_equals_two_score_batches(fix, cfg_parity, chunk):
    scorer = _port(fix[1], cfg_parity=cfg_parity)
    rng = np.random.default_rng(3)
    a, b, c = (rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8) for _ in range(3))
    kw = dict(prompt="a dog", target_step=600, seed=2334)
    s_ab, s_ac = scorer.score_triplet_batch(a, b, c, chunk=chunk, **kw)
    np.testing.assert_allclose(s_ab, scorer.score_batch(a, b, **kw), atol=1e-6)
    np.testing.assert_allclose(s_ac, scorer.score_batch(a, c, **kw), atol=1e-6)


def test_seeded_scores_are_deterministic_and_shared_by_every_pair(fix):
    scorer = _port(fix[1])
    a, b, _ = _inputs(4)
    first = scorer.score_batch(a, b, seed=7)
    np.testing.assert_array_equal(first, scorer.score_batch(a, b, seed=7))
    # one draw for the whole batch: a pair scores the same alone as in the batch
    np.testing.assert_allclose(scorer.score_batch(a[2:3], b[2:3], seed=7), first[2:3], atol=1e-6)
    assert not np.allclose(first, scorer.score_batch(a, b, seed=8), atol=1e-7)


def test_non_blocking_returns_a_fetch_callable(fix):
    scorer = _port(fix[1])
    a, b, c = (np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
               for _ in range(3))
    fetch = scorer.score_batch(a, b, blocking=False)
    assert callable(fetch)
    np.testing.assert_array_equal(fetch(), scorer.score_batch(a, b))
    fetch_pair = scorer.score_triplet_batch(a, b, c, blocking=False)
    for got, want in zip(fetch_pair(), scorer.score_triplet_batch(a, b, c)):
        np.testing.assert_array_equal(got, want)


def test_diffsim_on_image_paths(fix, tmp_path):
    """The path entry point: the same lanczos preprocessing as the JAX package, then
    score_batch on the single pair."""
    from PIL import Image

    from diffsim_tpu.core.image import load_and_process as jax_load
    from diffsim_tpu_torch.core.image import load_and_process

    rng = np.random.default_rng(6)
    paths = []
    for i in range(2):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    for path in paths:
        np.testing.assert_array_equal(load_and_process(path, 32), jax_load(path, 32))
    scorer = _port(fix[1])
    out = scorer.diffsim(paths[0], paths[1], target_step=600, seed=11)
    want = scorer.score_batch(load_and_process(paths[0], 32), load_and_process(paths[1], 32),
                              target_layer=(0,), target_step=600, seed=11)
    assert isinstance(out, float) and out == float(want[0])


def test_tap_translation_matches_jax():
    from diffsim_tpu.metrics.diffsim_sd15 import sd15_tap as jax_tap

    for args in [("up_blocks", (0,)), ("up_blocks", [5]), ("down_blocks", 1),
                 ("mid_blocks", 0), ("up_blocks", 2)]:
        for fix_collapse in (False, True):
            for text_attn in (False, True):
                ours = sd15_tap(*args, fix_layer_collapse=fix_collapse, text_attn=text_attn)
                ref = jax_tap(*args, fix_layer_collapse=fix_collapse, text_attn=text_attn)
                assert (ours.block, tuple(ours.address), ours.attn, ours.capture) == \
                    (ref.block, tuple(ref.address), ref.attn, ref.capture)


def test_parts_outside_this_slice_raise(fix):
    """The scorer's whole surface is ported (IP-Adapter, masks, score_feats_batch and
    tap_values: tests/test_torch_port_ip.py, tests/test_torch_port_surface.py), and so are the
    CLIP metrics' vision taps that its IP-Adapter encoder once left to them."""
    import dataclasses

    from diffsim_tpu_torch.models.clip_vision import CLIPVisionConfig
    from diffsim_tpu_torch.models.ip_adapter import ResamplerConfig

    scorer = _port(fix[1])
    scorer.enable_ip_adapter(encoder_cfg=CLIPVisionConfig.tiny(),
                             resampler_cfg=dataclasses.replace(ResamplerConfig.tiny(),
                                                               output_dim=32))
    a = np.zeros((1, 32, 32, 3), np.uint8)
    assert np.isfinite(scorer.score_batch(a, a, ip_adapter=True)).all()
    with torch.no_grad():  # the CLIP metrics' taps run on the IP-Adapter's encoder too
        taps = scorer.ip_encoder.tap(torch.zeros(1, 3, 32, 32), 0)
    assert sorted(taps) == ["k", "q", "v"]


def test_partial_weight_trees_are_refused(fix):
    """Converted weights never mix with random ones: all three trees or none."""
    with pytest.raises(ValueError, match="exactly"):
        _port({k: v for k, v in fix[1].items() if k != "text"})
