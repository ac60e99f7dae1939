"""The rest of the port's SD-1.5 scorer surface against the JAX package, in float32 on the CPU:
mask-weighted queries (``readout.mask_to_latent``, ``score_batch(mask_a=, mask_b=)`` at the
canonical tap and at a tap of 1024 tokens, whose readout takes K3's plain version), the
``diffeats`` readout (``score_feats_batch``), ``tap_values``, the host mask helpers
(``load_mask``, ``mask_path_for``, ``heuristic_matting``), and the CLI's ``--ip_adapter``,
``--use_mask`` (mask tree and heuristic) and ``--metric diffeats`` runs at tiny scale, whose
scores equal the port's own scorer calls on the same images and seed."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffsim_tpu.convert.diffusion_import import convert_sd_unet, convert_vae
from diffsim_tpu.core import image as jimage
from diffsim_tpu.metrics import ffa as jffa
from diffsim_tpu.metrics import readout as jreadout
from diffsim_tpu.metrics.diffsim_sd15 import DiffSimSD15 as JaxSD15
from diffsim_tpu.metrics.diffsim_sd15 import sd15_tap as jax_tap
from diffsim_tpu.models import clip_text as jclip
from diffsim_tpu.models import unet as junet
from diffsim_tpu.models import vae as jvae
from diffsim_tpu.ops.taps import OUTPUT as J_OUTPUT
from diffsim_tpu.ops.taps import TapSpec as JTapSpec
from diffsim_tpu_torch.cli.main import run_benchmark
from diffsim_tpu_torch.core import image as timage
from diffsim_tpu_torch.core import schedulers
from diffsim_tpu_torch.data import benchmarks
from diffsim_tpu_torch.metrics import ffa as tffa
from diffsim_tpu_torch.metrics import readout
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15, sd15_tap
from diffsim_tpu_torch.metrics.scorer_base import role_noise
from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNetConfig
from diffsim_tpu_torch.models.vae import VAEConfig
from diffsim_tpu_torch.ops.kernels import routes
from tests import fixtures

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_parity_tiny.npz")
ATOL = 5e-5
CUTE = dict(target_block="up_blocks", target_layer=[0], target_step=600, similarity="cosine",
            seed=2334)  # the cute preset



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def params():
    d = np.load(FIXTURE)
    sds = {"unet": {}, "vae": {}}
    for key in d.files:
        if key.startswith("sd::"):
            _, which, name = key.split("::", 2)
            sds[which][name] = d[key]
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(
        jclip.init(jax.random.PRNGKey(0), jclip.CLIPTextConfig.tiny(), jnp.float32)))
    return {
        "unet": jax.device_get(convert_sd_unet(sds["unet"], junet.UNetConfig.tiny(), strict=True)),
        "vae": jax.device_get(convert_vae(sds["vae"], jvae.VAEConfig.tiny(), strict=True)[0]),
        "text": jax.tree_util.tree_unflatten(
            treedef, [(rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32)
                      for x in leaves]),
    }


@pytest.fixture(scope="module")
def scorers(params):
    """(port, JAX) SD-1.5 scorers at 32 px and at 64 px."""
    out = {}
    for size in (32, 64):
        out[size] = (
            DiffSimSD15(params, unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny(),
                        text_cfg=CLIPTextConfig.tiny(), img_size=size, dtype=torch.float32,
                        device="cpu"),
            JaxSD15(params, unet_cfg=junet.UNetConfig.tiny(), vae_cfg=jvae.VAEConfig.tiny(),
                    text_cfg=jclip.CLIPTextConfig.tiny(), img_size=size, dtype=jnp.float32))
    return out


def _inputs(seed, n, size):
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8) for _ in range(2))
    noise = tuple(rng.standard_normal((2, size // 2, size // 2, 4)).astype(np.float32)
                  for _ in range(2))
    masks = np.zeros((2, n, size, size), np.float32)  # a foreground box per image
    for m in masks.reshape(-1, size, size):
        y, x = rng.integers(0, size // 2, 2)
        m[y:y + size // 3, x:x + size // 3] = 1.0
    return a, b, noise, list(masks)


# ---------------------------------------------------------------------------
# mask-weighted queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [4, 8, 16, 32, 64])
def test_mask_to_latent_matches_jax(side):
    """The 5x5 dilation and the antialiased resize, at every latent side of 512 px (16-64)
    and below."""
    m = (np.random.default_rng(side).uniform(size=(3, 2, 64, 64)) > 0.8).astype(np.float32)
    ref = np.asarray(jreadout.mask_to_latent(jnp.asarray(m), side))
    out = readout.mask_to_latent(torch.from_numpy(m), side).numpy()
    assert out.shape == (3, 2, side * side)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_masked_score_batch_matches_jax(scorers, size, similarity):
    """At 32 px the canonical tap (256 tokens: the math readout); at 64 px the same tap has
    1024 tokens, so the masked queries go through K3's plain version."""
    port, ref = scorers[size]
    a, b, noise, (ma, mb) = _inputs(size, 2, size)
    kw = dict(prompt="a cat", **{**CUTE, "similarity": similarity}, noise_override=noise)
    want = ref.score_batch(a, b, mask_a=ma, mask_b=mb, **kw)
    out = port.score_batch(a, b, mask_a=ma, mask_b=mb, **kw)
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
    assert routes.use_fused_readout((2, 2, 2, (size // 2) ** 2, 16)) == (size == 64)
    assert not np.allclose(out, port.score_batch(a, b, **kw))  # the masks count


# ---------------------------------------------------------------------------
# diffeats and tap_values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block,layer", [("up_blocks", [0]), ("down_blocks", 0)])
@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_score_feats_batch_matches_jax(scorers, block, layer, similarity):
    """attn1's OUTPUT at the (unwrapped) layer, min-max normalised. The JAX method draws its
    own noise, so the JAX side runs its scoring graph for that tap with the injected noise."""
    port, ref = scorers[32]
    a, b, noise, _ = _inputs(3, 3, 32)
    prompts = ["a cat", "a mug", "a cat"]
    out = port.score_feats_batch(a, b, prompt=prompts, target_block=block, target_layer=layer,
                                 target_step=600, similarity=similarity, noise_override=noise)
    base = jax_tap(block, layer[0] if isinstance(layer, list) else layer,
                   fix_layer_collapse=True)
    fn = ref._score_fn(JTapSpec(base.block, base.address, "attn1", J_OUTPUT), similarity,
                       inject_noise=True)
    embeds_u, pidx = ref._embeds_and_idx(prompts)
    sab, _ = ref._noise_consts(600, 2333)
    want = fn(ref.params, a, b, embeds_u, pidx, jnp.zeros((1, 1, 1)), jnp.zeros((1, 2, 1, 1)),
              sab, tuple(jnp.asarray(e) for e in noise))
    np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=ATOL)


def test_tap_values_shapes_and_draws(scorers, tmp_path):
    """The JAX package's shapes, (2, heads, S, D) with CFG parity; torch and JAX draw other
    noise from one seed, so the values are held to the port's own tap graph with role A's
    draws of that seed."""
    port, ref = scorers[32]
    path = str(tmp_path / "a.png")
    fixtures._img(7, 48).save(path)
    kw = dict(prompt="a cat", target_block="up_blocks", target_layer=(0,), target_step=600,
              seed=11)
    ours = port.tap_values(path, **kw)
    want = ref.tap_values(path, **kw)
    assert [tuple(t.shape) for t in ours] == [tuple(np.shape(t)) for t in want]
    assert ours[0].shape == (2, 2, 256, 16)
    with torch.inference_mode():
        moments = port._encode([timage.load_and_process(path, 32)])
        eps_vae, eps_noise = role_noise(11, 16, 16, 4, port.device)
        taps, _ = port._taps(moments, port.encode_prompt("a cat")[None], eps_vae[:1],
                             eps_noise[:1], schedulers.sd15_noise_spec(600),
                             sd15_tap("up_blocks", (0,)))
    for got, name in zip(ours, "qkv"):
        np.testing.assert_allclose(got.numpy(), taps[name][0].numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the host mask helpers
# ---------------------------------------------------------------------------


def _matting_images(tmp_path):
    """Fixture images (the heuristic inverts the matte of the second and warns) and two centred
    objects on flat borders."""
    paths = []
    for i, img in enumerate([fixtures._img(s, 40) for s in (1, 2)] + [None, None]):
        if img is None:
            arr = np.full((48, 40, 3), 30 if i == 2 else 200, np.uint8)
            arr[12:36, 10:30] = 220 if i == 2 else 20
            img = Image.fromarray(arr)
        path = str(tmp_path / f"m{i}.png")
        img.save(path)
        paths.append(path)
    return paths


def test_mask_helpers_match_jax(tmp_path):
    paths = _matting_images(tmp_path)
    warned = []
    for path in paths:
        with warnings.catch_warnings(record=True) as got_t:
            ours = np.asarray(tffa.heuristic_matting(Image.open(path)))
        with warnings.catch_warnings(record=True) as got_j:
            ref = np.asarray(jffa.heuristic_matting(Image.open(path)))
        np.testing.assert_array_equal(ours, ref)
        assert len(got_t) == len(got_j)
        warned.append(any(issubclass(w.category, tffa.MattingInversionWarning) for w in got_t))
        for size in (32, 64):
            np.testing.assert_array_equal(timage.load_mask(path, size),
                                          jimage.load_mask(path, size))
            np.testing.assert_array_equal(
                timage.mask_from_matting(tffa.heuristic_matting, path, size),
                jimage.mask_from_matting(jffa.heuristic_matting, path, size))
    assert warned == [False, True, False, False]  # both branches of the centre prior
    np.testing.assert_array_equal(timage.CLIP_MEAN, jimage.CLIP_MEAN)
    np.testing.assert_array_equal(timage.CLIP_STD, jimage.CLIP_STD)


def test_mask_path_for_matches_jax(tmp_path):
    images, masks = tmp_path / "img", tmp_path / "mask"
    for d in (images / "a", masks / "a"):
        d.mkdir(parents=True)
    (masks / "a" / "x.png").write_bytes(b"")  # the same relative path
    (masks / "a" / "y.png").write_bytes(b"")  # y.jpg's mask, by its stem
    for name in ("x.png", "y.jpg"):
        path = str(images / "a" / name)
        assert timage.mask_path_for(path, str(images), str(masks)) == \
            jimage.mask_path_for(path, str(images), str(masks))
    for mod in (timage, jimage):
        with pytest.raises(FileNotFoundError, match="no mask"):
            mod.mask_path_for(str(images / "a" / "z.jpg"), str(images), str(masks))


# ---------------------------------------------------------------------------
# the CLI at tiny scale
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cute(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cute"))
    tree = fixtures.make_cute(root)
    mask_root = os.path.join(root, "masks")
    rng = np.random.default_rng(3)
    for c in {p for c in benchmarks.cute(tree, 2334) for p in (c.a, c.b, c.c)}:
        dst = os.path.join(mask_root, os.path.relpath(c, tree))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        Image.fromarray(((rng.uniform(size=(40, 40)) > 0.5) * 255).astype(np.uint8)).save(dst)
    return tree, mask_root


BATCH, SHARDS = 4, 5  # comparisons 0, 5, ..., 35 of the 40: two scoring calls of 4


def _run(cute, tmp_path, *extra):
    tree, _ = cute
    path = str(tmp_path / "r.jsonl")
    argv = ["--preset", "cute", "--image_path", tree, "--image_size", "32", "--model_scale",
            "tiny", "--batch_size", str(BATCH), "--shard", f"0/{SHARDS}", "--results", path,
            *extra]
    report, (adapter,) = run_benchmark("cute", argv, device="cpu")
    recs = [json.loads(line) for line in open(f"{path}.s0-{SHARDS}")]
    assert report.total == 8 and all(set(r) == {"idx", "s_ab", "s_ac"} for r in recs)
    assert sorted(r["idx"] for r in recs) == list(range(8))
    return {r["idx"]: (r["s_ab"], r["s_ac"]) for r in recs}, adapter


def _first_batch(tree, mask_fn=None):
    """The runner's first scoring call: pixels [a..., a...] vs [b..., c...] and their masks."""
    plan = benchmarks.cute(tree, 2334)[::SHARDS][:BATCH]
    role = {r: [getattr(c, r) for c in plan] for r in "abc"}
    pix = {r: np.concatenate([timage.load_and_process_u8(p, 32) for p in role[r]])
           for r in "abc"}
    out = dict(pix_a=np.concatenate([pix["a"]] * 2), pix_b=np.concatenate([pix["b"], pix["c"]]),
               prompt=[c.prompt for c in plan] * 2)
    if mask_fn is not None:
        m = {r: np.concatenate([mask_fn(p) for p in role[r]]) for r in "abc"}
        out.update(mask_a=np.concatenate([m["a"]] * 2), mask_b=np.concatenate([m["b"], m["c"]]))
    return out


def _held_to(scores, want):
    got = np.array([scores[i] for i in range(BATCH)]).T.reshape(-1)  # [s_ab..., s_ac...]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weights", [False, True])
def test_cli_ip_adapter_runs_the_pair_path(cute, tmp_path, weights):
    """Random adapter weights, or ``--ip_weights``: a converted tiny ip-adapter-plus written
    as the converters' ``.npz`` (the encoder stays random, as in the JAX CLI)."""
    extra = ["--ip_adapter"]
    if weights:
        from diffsim_tpu_torch.convert import store
        from diffsim_tpu_torch.convert.torch_import import convert_ip_adapter
        from tests.test_torch_port_ip import _ip_adapter_sd

        converted = convert_ip_adapter(_ip_adapter_sd(UNetConfig.tiny(), np.random.default_rng(4),
                                                      True), UNetConfig.tiny())
        path = str(tmp_path / "ip.npz")
        store.save_params(path, converted)
        extra += ["--ip_weights", path]
    scores, adapter = _run(cute, tmp_path, *extra)
    assert adapter.score_triplets is None and adapter.score_triplet_paths is None
    assert adapter.scorer._ip["scale"] == 0.5 and adapter.scorer._ip["plus"]
    if weights:
        np.testing.assert_array_equal(adapter.scorer.ip_proj.latents.detach().numpy(),
                                      converted["image_proj"]["latents"])
    batch = _first_batch(cute[0])
    _held_to(scores, adapter.scorer.score_batch(batch.pop("pix_a"), batch.pop("pix_b"),
                                                ip_adapter=True, **batch, **CUTE))


@pytest.mark.parametrize("source", ["mask_path", "heuristic"])
def test_cli_use_mask(cute, tmp_path, capsys, source):
    tree, mask_root = cute
    extra = ["--use_mask"] + (["--mask_path", mask_root] if source == "mask_path" else [])
    scores, adapter = _run(cute, tmp_path, *extra)
    assert adapter.wants_masks
    if source == "mask_path":
        def mask_fn(p):
            return timage.load_mask(timage.mask_path_for(p, tree, mask_root), 32)
    else:
        assert "border-statistics heuristic" in capsys.readouterr().out

        def mask_fn(p):
            return timage.mask_from_matting(tffa.heuristic_matting, p, 32)
    batch = _first_batch(tree, mask_fn)
    _held_to(scores, adapter.scorer.score_batch(batch.pop("pix_a"), batch.pop("pix_b"),
                                                **batch, **CUTE))


def test_cli_metric_diffeats(cute, tmp_path):
    scores, adapter = _run(cute, tmp_path, "--metric", "diffeats")
    assert adapter.score_triplets is None and not adapter.wants_masks
    batch = _first_batch(cute[0])
    _held_to(scores, adapter.scorer.score_feats_batch(batch.pop("pix_a"), batch.pop("pix_b"),
                                                      **batch, **CUTE))
