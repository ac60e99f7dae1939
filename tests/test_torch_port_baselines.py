"""The PyTorch port's baseline metrics against the JAX package's, in float32 on the CPU: the CLIP
vision taps and the out-projection replay, DINOv2 / DINO v1 with the position grid shrunk and
grown, VGG features, LPIPS, the Gram rows at two shapes and ragged, U^2-Net at even and odd
sizes, its matting, FFA, every baseline scorer's scores (within 5e-5), the converters leaf for
leaf, the bridge's round trips and ``cli/convert``'s files byte for byte. Inputs come from
seeded numpy; the port's weights go through the bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import save_file as st_save_file

from diffsim_tpu.cli import convert as jcli
from diffsim_tpu.convert import store as jax_store
from diffsim_tpu.convert import torch_import as JTI
from diffsim_tpu.convert.u2net_import import convert_u2net as j_convert_u2net
from diffsim_tpu.core import image as jimage
from diffsim_tpu.core.tokenizer import HashTokenizer as JHashTokenizer
from diffsim_tpu.metrics import clip_i as jclip_i
from diffsim_tpu.metrics import dino as jdino
from diffsim_tpu.metrics import ffa as jffa
from diffsim_tpu.metrics import lpips as jlpips
from diffsim_tpu.metrics import vgg_gram as jgram
from diffsim_tpu.models import clip_text as jct
from diffsim_tpu.models import clip_vision as jcv
from diffsim_tpu.models import dinov2 as jd
from diffsim_tpu.models import u2net as ju
from diffsim_tpu.models import vgg as jvgg
from diffsim_tpu_torch.cli import convert as tcli
from diffsim_tpu_torch.convert import bridge, store
from diffsim_tpu_torch.convert import torch_import as TI
from diffsim_tpu_torch.convert.u2net_import import convert_u2net
from diffsim_tpu_torch.core import image as timage
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
from diffsim_tpu_torch.metrics.clip_i import CLIPPair, CLIPScore
from diffsim_tpu_torch.metrics import ffa as tffa
from diffsim_tpu_torch.metrics.dino import DinoScore, Dinov2Score
from diffsim_tpu_torch.metrics.ffa import ForegroundFeatureAveraging, U2NetMatting
from diffsim_tpu_torch.metrics.lpips import LPIPS, LPIPSNet
from diffsim_tpu_torch.metrics.vgg_gram import VGGGram
from diffsim_tpu_torch.models import dinov2 as td
from diffsim_tpu_torch.models import u2net as tu
from diffsim_tpu_torch.models import vgg as tvgg
from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
from diffsim_tpu_torch.models.clip_vision import CLIPVision, CLIPVisionConfig, out_proj_replay
from tools.torch_u2net import U2Net as MirrorU2Net

TOL = dict(rtol=0, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)  # the convolution nets, as tests/test_u2net.py
SCORE_ATOL = 5e-5
# the CLIP text tower of the tests: tiny, with a projection (clip_t reads it)
TEXT = dict(vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64, projection_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redrawn(tree, seed, std=0.1):
    """A JAX tree with every leaf redrawn N(0, std) from ``seed`` (numpy)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(np.shape(x)) * std).astype(np.float32) for x in leaves])


def _built(factory, tree, kind):
    with torch.device("meta"):
        module = factory()
    return bridge.load(module, tree, kind, "cpu", torch.float32).eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _assert_same_tree(ours, ref):
    a, b = store._flatten(ours), jax_store._flatten(ref)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


# ---------------------------------------------------------------------------
# seeded weight trees, module-scoped
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_tree():
    return {"vision": _redrawn(jcv.init(jax.random.PRNGKey(0), jcv.CLIPVisionConfig.tiny()), 1),
            "text": _redrawn(jct.init(jax.random.PRNGKey(1), jct.CLIPTextConfig(**TEXT)), 2)}


@pytest.fixture(scope="module")
def dino_trees():
    return {ls: _redrawn(jd.init(jax.random.PRNGKey(0), jd.DinoConfig.tiny(layerscale=ls)),
                         3 + ls) for ls in (True, False)}


@pytest.fixture(scope="module")
def lpips_tree():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return jax.device_get({"vgg": jvgg.init(k1, jvgg.VGG16_CFG),
                           "lins": jlpips._lin_init(k2, jnp.float32)})


@pytest.fixture(scope="module")
def vgg19_tree():
    return jax.device_get(jvgg.init(jax.random.PRNGKey(5), jvgg.VGG19_CFG))


def _mirror_u2net(cfg):
    torch.manual_seed(0)
    return MirrorU2Net(cfg.encoder, cfg.decoder, cfg.side_channels).eval()


@pytest.fixture(scope="module")
def u2net_tiny_tree():
    sd = {k: v.numpy() for k, v in _mirror_u2net(ju.U2NetConfig.tiny()).state_dict().items()}
    return j_convert_u2net(sd, ju.U2NetConfig.tiny())


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capture", ["qkv", "output"])
@pytest.mark.parametrize("layer", [0, 1, -1])
def test_clip_vision_taps_and_out_proj_replay_match_jax(clip_tree, capture, layer):
    jcfg = jcv.CLIPVisionConfig.tiny()
    x = np.random.default_rng(6).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = jcv.apply(clip_tree["vision"], jnp.asarray(x), jcfg, tap_layer=layer,
                    capture=capture)
    model = _built(lambda: CLIPVision(CLIPVisionConfig.tiny()), clip_tree["vision"],
                   "clip_vision")
    with torch.no_grad():
        taps = model.tap(_nchw(x), layer, capture)
        full = model(_nchw(x))
    assert sorted(taps) == sorted(ref["taps"])
    for key, want in ref["taps"].items():
        np.testing.assert_allclose(taps[key].numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(full["image_embeds"].numpy(), np.asarray(ref["image_embeds"]),
                               **TOL)
    if capture == "qkv":  # the tap layer's out-projection over a merged context
        ctx = np.random.default_rng(7).standard_normal(ref["taps"]["q"].shape)
        ctx = ctx.astype(np.float32)
        want = jcv.out_proj_replay(clip_tree["vision"], jnp.asarray(ctx), jcfg, layer)
        with torch.no_grad():
            ours = out_proj_replay(model, torch.from_numpy(ctx), layer)
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("grid,target", [(37, 16), (37, 24), (28, 20), (4, 6), (4, 3), (5, 5)])
def test_position_resize_matches_jax_bicubic(grid, target):
    pos = np.random.default_rng(grid * target).standard_normal((grid * grid + 1, 8))
    pos = pos.astype(np.float32)
    ours = td.interpolate_pos_embed(torch.from_numpy(pos), target).numpy()
    ref = np.asarray(jd.interpolate_pos_embed(jnp.asarray(pos), target))
    assert ours.shape == (target * target + 1, 8)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-6)


@pytest.mark.parametrize("layerscale", [True, False], ids=["v2", "v1"])
@pytest.mark.parametrize("size", [24, 32, 64], ids=["shrink", "same", "grow"])
def test_dino_forward_and_taps_match_jax(dino_trees, layerscale, size):
    """The tiny tower stores a 4 x 4 grid: 24 px shrinks it to 3 x 3, 64 px grows it to 8 x 8.
    The ``v1`` case has DINO v1's layout (no LayerScale)."""
    jcfg = jd.DinoConfig.tiny(layerscale=layerscale)
    tree = dino_trees[layerscale]
    model = _built(lambda: td.Dino(td.DinoConfig.tiny(layerscale=layerscale)), tree, "dino")
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)

    @jax.jit
    def jax_fn(p, x_):
        return (jd.apply(p, x_, jcfg),
                *(jd.apply(p, x_, jcfg, tap_layer=1, capture=c)["taps"] for c in ("qkv",
                                                                                 "output")))

    ref, *ref_taps = jax_fn(tree, jnp.asarray(x))
    with torch.no_grad():
        out = model(_nchw(x))
    np.testing.assert_allclose(out["last_hidden_state"].numpy(),
                               np.asarray(ref["last_hidden_state"]), **TOL)
    np.testing.assert_allclose(out["cls"].numpy(), np.asarray(ref["cls"]), **TOL)
    for capture, want in zip(("qkv", "output"), ref_taps):
        with torch.no_grad():
            taps = model.tap(_nchw(x), 1, capture)
        for key in want:
            np.testing.assert_allclose(taps[key].numpy(), np.asarray(want[key]), **TOL)


def test_dino_configs_match_jax():
    for name in ("v2_small", "v2_base", "v1_vits8", "tiny"):
        assert dataclasses.asdict(getattr(td.DinoConfig, name)()) == \
            dataclasses.asdict(getattr(jd.DinoConfig, name)())
    for name in ("u2netp", "u2net", "tiny"):
        assert dataclasses.asdict(getattr(tu.U2NetConfig, name)()) == \
            dataclasses.asdict(getattr(ju.U2NetConfig, name)())
    assert tvgg.VGG16_CFG == jvgg.VGG16_CFG and tvgg.VGG19_CFG == jvgg.VGG19_CFG
    assert (tvgg.LPIPS_VGG16_TAPS, tvgg.VGG19_CONV5_1) == (jvgg.LPIPS_VGG16_TAPS,
                                                          jvgg.VGG19_CONV5_1)


@pytest.mark.parametrize("net", ["vgg16", "vgg19"])
def test_vgg_features_match_jax(lpips_tree, vgg19_tree, net):
    cfg, tree, taps = ((jvgg.VGG16_CFG, lpips_tree["vgg"], jvgg.LPIPS_VGG16_TAPS) if net == "vgg16"
                       else (jvgg.VGG19_CFG, vgg19_tree, (jvgg.VGG19_CONV5_1, 30)))
    model = _built(lambda: tvgg.VGG(cfg), tree, "vgg")
    x = np.random.default_rng(8).standard_normal((2, 32, 48, 3)).astype(np.float32)
    _, ref = jvgg.features(tree, jnp.asarray(x), cfg, taps=taps)
    with torch.no_grad():
        final, ours = model.features(_nchw(x), taps)
    assert final is None and sorted(ours) == sorted(ref)
    for idx in taps:
        want = np.asarray(ref[idx])
        np.testing.assert_allclose(ours[idx].permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("cfg,size", [("tiny", 65), ("u2netp", 64)])
def test_u2net_matches_jax(cfg, size):
    """Odd sizes run the ceil-mode pooling and the bilinear re-alignment of every upsample."""
    jcfg = getattr(ju.U2NetConfig, cfg)()
    sd = {k: v.numpy() for k, v in _mirror_u2net(jcfg).state_dict().items()}
    tree = j_convert_u2net(sd, jcfg)
    model = _built(lambda: tu.U2Net(getattr(tu.U2NetConfig, cfg)()), tree, "u2net")
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model(_nchw(x)).numpy()
    ref = jax.jit(lambda p, x_: ju.apply(p, x_, jcfg))(tree, jnp.asarray(x))
    np.testing.assert_allclose(ours, np.asarray(ref), **CONV_TOL)


def _blob_image(seed, size=(80, 64)):
    """A bright ellipse on a darker noisy ground: a salient object."""
    rng = np.random.default_rng(seed)
    w, h = size
    yy, xx = np.mgrid[:h, :w]
    inside = ((yy - h / 2) / (h / 3)) ** 2 + ((xx - w / 2) / (w / 4)) ** 2 < 1
    img = rng.integers(20, 80, (h, w, 3)).astype(np.uint8)
    img[inside] = rng.integers(180, 255, (int(inside.sum()), 3))
    return Image.fromarray(img)


@pytest.fixture()
def matte_64(monkeypatch):
    """The port's U^2-Net input side at 64 px, the JAX matting's ``size=64`` in these tests."""
    monkeypatch.setattr(tffa, "MATTE_SIZE", 64)


def test_u2net_matting_matches_jax(u2net_tiny_tree, matte_64):
    """The saliency before the cut within 1e-4; the hard matte may flip only pixels whose
    saliency lies within 1e-4 of the threshold."""
    img = _blob_image(10)
    ours = U2NetMatting(u2net_tiny_tree, tu.U2NetConfig.tiny(), device="cpu")
    ref = jffa.U2NetMatting(u2net_tiny_tree, ju.U2NetConfig.tiny(), size=64)
    small = np.asarray(img.convert("RGB").resize((64, 64), Image.BILINEAR), np.float32)
    pred = np.asarray(ref._fn(ref.params, jnp.asarray(small)[None]))[0]
    want = (pred - pred.min()) / (pred.max() - pred.min() + 1e-8)
    sal = ours.saliency(img)
    np.testing.assert_allclose(sal, want, rtol=0, atol=1e-4)
    a, b = np.asarray(ours(img)), np.asarray(ref(img))
    assert a.shape == b.shape == (64, 80, 4)
    np.testing.assert_array_equal(a[..., :3], b[..., :3])
    near = np.abs(want - 0.5) <= 1e-4
    flipped = (sal >= 0.5) != (want >= 0.5)
    assert not (flipped & ~near).any()


# ---------------------------------------------------------------------------
# the scorers, on the same weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_pair(clip_tree):
    vcfg, tcfg = jcv.CLIPVisionConfig.tiny(), jct.CLIPTextConfig(**TEXT)
    ref = jclip_i.CLIPScore(clip_tree, vision_cfg=vcfg, text_cfg=tcfg,
                            tokenizer=JHashTokenizer(1000))
    ours = CLIPScore(clip_tree, vision_cfg=CLIPVisionConfig.tiny(),
                     text_cfg=CLIPTextConfig(**TEXT), tokenizer=HashTokenizer(1000),
                     device="cpu")
    return ours, ref


@pytest.mark.parametrize("method,layer", [("clipi_score_batch", None),
                                          ("clip_cross_score_batch", 0),
                                          ("clip_cross_score_batch", [1]),
                                          ("clip_feature_score_batch", -1),
                                          ("clip_feature_score_batch", 0)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_clip_scores_match_jax(clip_pair, method, layer, dtype):
    ours, ref = clip_pair
    a, b = _u8(11, 4, 32, 32, 3), _u8(12, 4, 32, 32, 3)
    if dtype == "float32":  # already CLIP-normalised pixels pass as they are
        a, b = (np.random.default_rng(s).standard_normal((4, 32, 32, 3)).astype(np.float32)
                for s in (13, 14))
    extra = () if layer is None else (layer,)
    got = getattr(ours, method)(a, b, *extra)
    want = getattr(ref, method)(a, b, *extra)
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    fetch = getattr(ours, method)(a, b, *extra, blocking=False)
    np.testing.assert_array_equal(fetch(), got)


def test_clip_text_scores_and_single_pair_helpers_match_jax(clip_pair):
    ours, ref = clip_pair
    pix = _u8(15, 3, 32, 32, 3)
    texts = ["a cat", "a photo of a mug", "two dogs"]
    np.testing.assert_allclose(ours.text_features(texts), ref.text_features(texts), **TOL)
    np.testing.assert_allclose(ours.image_features(pix), ref.image_features(pix), **TOL)
    np.testing.assert_allclose(ours.clipt_score_batch(texts, pix),
                               ref.clipt_score_batch(texts, pix), rtol=0, atol=SCORE_ATOL)
    img_a, img_b = _blob_image(16, (48, 40)), _blob_image(17, (40, 56))
    np.testing.assert_array_equal(ours.preprocess(img_a), ref.preprocess(img_a))
    got, n = ours.clipi_score(img_a, img_b)
    want, _ = ref.clipi_score(img_a, img_b)
    assert n == 1 and abs(got - want) <= SCORE_ATOL
    assert abs(ours.clip_cross_score(img_a, img_b, 1) - ref.clip_cross_score(img_a, img_b, 1)) \
        <= SCORE_ATOL
    with pytest.raises(ValueError, match="single target_layer"):
        ours.clip_cross_score_batch(pix, pix, [0, 1])


@pytest.fixture(scope="module")
def dino_pairs(dino_trees):
    """{scorer: (port scorer, JAX scorer)} on the same tiny trees: DINOv2's layout, and DINO
    v1's (no LayerScale)."""
    return {name: (cls(dino_trees[ls], cfg=td.DinoConfig.tiny(layerscale=ls), device="cpu"),
                   jcls(dino_trees[ls], cfg=jd.DinoConfig.tiny(layerscale=ls)))
            for name, ls, cls, jcls in (("dinov2", True, Dinov2Score, jdino.Dinov2Score),
                                        ("dinov1", False, DinoScore, jdino.DinoScore))}


@pytest.mark.parametrize("scorer", ["dinov2", "dinov1"])
@pytest.mark.parametrize("method,layer", [("dino_score_batch", None),
                                          ("dino_cross_score_batch", 1),
                                          ("dino_cross_score_batch", [0]),
                                          ("dino_feature_score_batch", -1)])
def test_dino_scores_match_jax(dino_pairs, scorer, method, layer):
    """At 224 px (the DINO crop): the tiny tower's 28 x 28 grid grows from its stored 4 x 4."""
    ours, ref = dino_pairs[scorer]
    a, b = _u8(18, 2, 224, 224, 3), _u8(19, 2, 224, 224, 3)
    extra = () if layer is None else (layer,)
    np.testing.assert_allclose(getattr(ours, method)(a, b, *extra),
                               getattr(ref, method)(a, b, *extra), rtol=0, atol=SCORE_ATOL)


def test_dino_defaults_preprocess_and_features_match_jax(dino_trees):
    assert Dinov2Score.cfg_factory() == td.DinoConfig.v2_small()
    assert DinoScore.cfg_factory() == td.DinoConfig.v1_vits8()
    img = _blob_image(20, (300, 260))
    ours = Dinov2Score(dino_trees[True], cfg=td.DinoConfig.tiny(), device="cpu")
    ref = jdino.Dinov2Score(dino_trees[True], cfg=jd.DinoConfig.tiny())
    np.testing.assert_array_equal(ours.preprocess(img), ref.preprocess(img))
    pix = ours.preprocess(img)
    np.testing.assert_allclose(ours.image_features(pix), ref.image_features(pix), **TOL)
    for size in (224, 100):
        np.testing.assert_array_equal(timage.clip_preprocess_u8(img, size),
                                      jimage.clip_preprocess_u8(img, size))
        np.testing.assert_allclose(timage.clip_preprocess(img, size),
                                   jimage.clip_preprocess(img, size), rtol=0, atol=0)
    np.testing.assert_allclose(timage.dino_preprocess(img), jimage.dino_preprocess(img),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_lpips_scores_match_jax(lpips_tree, dtype):
    """Redrawn non-negative lins, so that every stage weighs in."""
    tree = {**lpips_tree, "lins": [{"w": np.abs(np.random.default_rng(i).standard_normal(
        lin["w"].shape)).astype(np.float32)} for i, lin in enumerate(lpips_tree["lins"])]}
    a, b = _u8(21, 3, 32, 32, 3), _u8(22, 3, 32, 32, 3)
    if dtype == "float32":
        a, b = (x.astype(np.float32) / 127.5 - 1.0 for x in (a, b))
    ours = LPIPS(tree, device="cpu")
    got = ours.score_batch(a, b)
    want = np.asarray(jlpips.LPIPS(tree).score_batch(a, b))
    assert (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=SCORE_ATOL)
    np.testing.assert_array_equal(ours(a, a), np.zeros(3, np.float32))


def test_gram_rows_and_ragged_scores_match_jax(vgg19_tree):
    """Two shapes, stacked and as one ragged list, in and out of order."""
    ours, ref = VGGGram(vgg19_tree, device="cpu"), jgram.VGGGram(vgg19_tree)
    shapes = [(32, 48), (48, 32), (32, 48), (40, 40)]
    items_a = [_u8(30 + i, 1, h, w, 3) for i, (h, w) in enumerate(shapes)]
    items_b = [_u8(40 + i, h, w, 3) for i, (h, w) in enumerate(shapes)]  # (H, W, 3) items too
    for shape in ((32, 48), (40, 40)):
        pix = _u8(50, 2, *shape, 3)
        want = np.asarray(ref._gram_rows(pix))
        np.testing.assert_allclose(ours._gram_rows(pix).numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    got = ours.score_batch(items_a, items_b)
    want = ref.score_batch(items_a, items_b)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    fetch = ours.score_batch(items_a, items_b, blocking=False)
    np.testing.assert_array_equal(fetch(), got)
    stacked = _u8(60, 2, 32, 48, 3), _u8(61, 2, 32, 48, 3)
    np.testing.assert_allclose(ours.score_batch(*stacked), ref.score_batch(*stacked), rtol=0,
                               atol=SCORE_ATOL)
    img = _blob_image(62, (90, 60))
    np.testing.assert_array_equal(ours.preprocess(img, 48), ref.preprocess(img, 48))


@pytest.fixture(scope="module")
def ffa_tree():
    cfg = dataclasses.replace(jd.DinoConfig.tiny(), patch=14)
    return _redrawn(jd.init(jax.random.PRNGKey(0), cfg), 23)


@pytest.mark.parametrize("matting", ["heuristic", "u2net"])
def test_ffa_matches_jax(ffa_tree, u2net_tiny_tree, matte_64, matting):
    """FFA with the tiny DINO at patch 14 (the 24 x 24 grid at 336 px): the matted inputs equal,
    features within 1e-5, scores within 5e-5."""
    tcfg = dataclasses.replace(td.DinoConfig.tiny(), patch=14)
    jcfg = dataclasses.replace(jd.DinoConfig.tiny(), patch=14)
    t_mat = j_mat = None
    if matting == "u2net":
        t_mat = U2NetMatting(u2net_tiny_tree, tu.U2NetConfig.tiny(), device="cpu")
        j_mat = jffa.U2NetMatting(u2net_tiny_tree, ju.U2NetConfig.tiny(), size=64)
    ours = ForegroundFeatureAveraging(ffa_tree, cfg=tcfg, matting=t_mat, device="cpu")
    ref = jffa.ForegroundFeatureAveraging(ffa_tree, cfg=jcfg, matting=j_mat)
    imgs = [_blob_image(70 + i, (72 + 8 * i, 64)) for i in range(4)]
    rgba = [ours.preprocess(im) for im in imgs]
    for got, im in zip(rgba, imgs):
        np.testing.assert_array_equal(got, ref.preprocess(im))
    a, b = np.concatenate(rgba[:2]), np.concatenate(rgba[2:])
    np.testing.assert_allclose(ours.features(a), ref.features(a), **TOL)
    np.testing.assert_allclose(ours.score_batch("Crop-Feat", a, b),
                               ref.score_batch("Crop-Feat", a, b), rtol=0, atol=SCORE_ATOL)
    raw = _u8(80, 2, 336, 336, 3)
    np.testing.assert_allclose(ours.features(a, "Crop-Img", raw), ref.features(a, "Crop-Img", raw),
                               **TOL)
    assert abs(ours("Crop-Feat", imgs[:1], imgs[1:2]) - ref("Crop-Feat", imgs[:1], imgs[1:2])) \
        <= SCORE_ATOL


# ---------------------------------------------------------------------------
# the converters and the bridge
# ---------------------------------------------------------------------------


def _r(rng):
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return r


def _vit_layer(r, h, inter, base, names):
    """One ViT layer's state dict under ``base`` with the given (norm1, q, k, v, out, norm2,
    fc1, fc2) names."""
    n1, q, k, v, out, n2, f1, f2 = names
    sd = {}
    for nm in (n1, n2):
        sd[f"{base}.{nm}.weight"], sd[f"{base}.{nm}.bias"] = r(h), r(h)
    for nm in (q, k, v, out):
        sd[f"{base}.{nm}.weight"], sd[f"{base}.{nm}.bias"] = r(h, h), r(h)
    sd[f"{base}.{f1}.weight"], sd[f"{base}.{f1}.bias"] = r(inter, h), r(inter)
    sd[f"{base}.{f2}.weight"], sd[f"{base}.{f2}.bias"] = r(h, inter), r(h)
    return sd


def dinov2_sd(cfg, rng) -> dict:
    """HF ``Dinov2Model`` names (the mask token included, which no leaf reads)."""
    r, h, p = _r(rng), cfg.hidden, cfg.patch
    sd = {"embeddings.cls_token": r(1, 1, h), "embeddings.mask_token": r(1, h),
          "embeddings.position_embeddings": r(1, cfg.pos_grid ** 2 + 1, h),
          "embeddings.patch_embeddings.projection.weight": r(h, 3, p, p),
          "embeddings.patch_embeddings.projection.bias": r(h),
          "layernorm.weight": r(h), "layernorm.bias": r(h)}
    names = ("norm1", "attention.attention.query", "attention.attention.key",
             "attention.attention.value", "attention.output.dense", "norm2", "mlp.fc1", "mlp.fc2")
    for i in range(cfg.layers):
        sd.update(_vit_layer(r, h, cfg.intermediate, f"encoder.layer.{i}", names))
        sd[f"encoder.layer.{i}.layer_scale1.lambda1"] = r(h)
        sd[f"encoder.layer.{i}.layer_scale2.lambda1"] = r(h)
    return sd


def dino_v1_sd(cfg, rng, qkv_bias: bool = True) -> dict:
    """facebookresearch/dino ``VisionTransformer`` names: fused qkv."""
    r, h, p = _r(rng), cfg.hidden, cfg.patch
    sd = {"cls_token": r(1, 1, h), "pos_embed": r(1, cfg.pos_grid ** 2 + 1, h),
          "patch_embed.proj.weight": r(h, 3, p, p), "patch_embed.proj.bias": r(h),
          "norm.weight": r(h), "norm.bias": r(h)}
    for i in range(cfg.layers):
        base = f"blocks.{i}"
        layer = _vit_layer(r, h, cfg.intermediate, base, ("norm1", "q", "k", "v", "attn.proj",
                                                          "norm2", "mlp.fc1", "mlp.fc2"))
        for nm in "qkv":
            layer.pop(f"{base}.{nm}.weight"), layer.pop(f"{base}.{nm}.bias")
        layer[f"{base}.attn.qkv.weight"] = r(3 * h, h)
        if qkv_bias:
            layer[f"{base}.attn.qkv.bias"] = r(3 * h)
        sd.update(layer)
    return sd


def vgg_features_sd(cfg, rng, prefix="features.") -> dict:
    """torchvision ``vgg*.features`` names at ``cfg``'s widths."""
    r, sd, idx, cin = _r(rng), {}, 0, 3
    for item in cfg:
        if item == "M":
            idx += 1
            continue
        sd[f"{prefix}{idx}.weight"], sd[f"{prefix}{idx}.bias"] = r(item, cin, 3, 3), r(item)
        cin, idx = item, idx + 2
    return sd


def lpips_sd(rng, vgg_cfg=None) -> dict:
    """The published LPIPS heads (``lin{i}.model.1.weight``), with the trunk under ``net.``
    when ``vgg_cfg`` is given."""
    r = _r(rng)
    sd = {f"lin{i}.model.1.weight": np.abs(r(1, c, 1, 1))
          for i, c in enumerate((64, 128, 256, 512, 512))}
    if vgg_cfg is not None:
        sd.update(vgg_features_sd(vgg_cfg, rng, prefix="net."))
    return sd


SMALL_VGG = [8, 8, "M", 16, "M", 16, 16]  # a short conv stack for the CLI files


def clip_sd(rng) -> dict:
    """HF ``CLIPModel`` names at the tiny widths: both towers and both projections."""
    r, vc = _r(rng), jcv.CLIPVisionConfig.tiny()
    h, p = vc.hidden, vc.patch
    sd = {"vision_model.embeddings.class_embedding": r(h),
          "vision_model.embeddings.patch_embedding.weight": r(h, 3, p, p),
          "vision_model.embeddings.position_embedding.weight": r(vc.tokens, h),
          "vision_model.pre_layrnorm.weight": r(h), "vision_model.pre_layrnorm.bias": r(h),
          "vision_model.post_layernorm.weight": r(h), "vision_model.post_layernorm.bias": r(h),
          "visual_projection.weight": r(vc.projection_dim, h),
          "text_model.embeddings.token_embedding.weight": r(TEXT["vocab_size"], 32),
          "text_model.embeddings.position_embedding.weight": r(77, 32),
          "text_model.final_layer_norm.weight": r(32), "text_model.final_layer_norm.bias": r(32),
          "text_projection.weight": r(TEXT["projection_dim"], 32)}
    names = ("layer_norm1", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.out_proj", "layer_norm2", "mlp.fc1", "mlp.fc2")
    for tower, inter in (("vision_model", vc.intermediate), ("text_model", 64)):
        for i in range(2):
            sd.update(_vit_layer(r, 32, inter, f"{tower}.encoder.layers.{i}", names))
    return sd


@pytest.mark.parametrize("family", ["dinov2", "dino_v1", "dino_v1_no_qkv_bias", "vgg",
                                    "vgg_bare", "lpips", "lpips_with_net", "u2net"])
def test_converters_match_jax(family):
    rng = np.random.default_rng(90)
    if family == "dinov2":
        cfg = jd.DinoConfig.tiny()
        sd = dinov2_sd(cfg, rng)
        ours, ref = TI.convert_dinov2(sd, cfg), JTI.convert_dinov2(sd, cfg)
    elif family.startswith("dino_v1"):
        cfg = jd.DinoConfig.tiny(layerscale=False)
        sd = dino_v1_sd(cfg, rng, qkv_bias=not family.endswith("bias"))
        ours, ref = TI.convert_dino_v1(sd, cfg), JTI.convert_dino_v1(sd, cfg)
    elif family.startswith("vgg"):
        sd = vgg_features_sd(jvgg.VGG19_CFG[:7], rng, "" if family.endswith("bare") else
                             "features.")
        ours = TI.convert_vgg_features(sd, jvgg.VGG19_CFG[:7])
        ref = JTI.convert_vgg_features(sd, jvgg.VGG19_CFG[:7])
    elif family.startswith("lpips"):
        sd = lpips_sd(rng, SMALL_VGG if family.endswith("net") else None)
        ours, ref = TI.convert_lpips(sd, SMALL_VGG), JTI.convert_lpips(sd, SMALL_VGG)
        assert ("vgg" in ours) == family.endswith("net")
    else:
        sd = {k: v.numpy() for k, v in _mirror_u2net(ju.U2NetConfig.tiny()).state_dict().items()}
        ours = convert_u2net(sd, tu.U2NetConfig.tiny())
        ref = j_convert_u2net(sd, ju.U2NetConfig.tiny())
        with pytest.raises(ValueError, match="unconsumed"):
            convert_u2net({**sd, "extra.weight": np.zeros(1)}, tu.U2NetConfig.tiny())
    _assert_same_tree(ours, ref)


@pytest.mark.parametrize("kind", ["clip", "dino", "dino_v1", "vgg", "lpips", "u2net"])
def test_bridge_round_trips_the_baseline_trees_strictly(clip_tree, dino_trees, lpips_tree,
                                                        u2net_tiny_tree, kind):
    """from_jax_tree -> the module's strict load -> to_jax_tree gives the tree back, leaf for
    leaf; an unknown leaf is refused."""
    cases = {
        "clip": (lambda: CLIPPair(CLIPVisionConfig.tiny(), CLIPTextConfig(**TEXT)), clip_tree),
        "dino": (lambda: td.Dino(td.DinoConfig.tiny()), dino_trees[True]),
        "dino_v1": (lambda: td.Dino(td.DinoConfig.tiny(layerscale=False)), dino_trees[False]),
        "vgg": (lambda: tvgg.VGG(tvgg.VGG16_CFG), lpips_tree["vgg"]),
        "lpips": (LPIPSNet, lpips_tree),
        "u2net": (lambda: tu.U2Net(tu.U2NetConfig.tiny()), u2net_tiny_tree),
    }
    factory, tree = cases[kind]
    kind = kind.split("_")[0]
    module = _built(factory, tree, kind)
    _assert_same_tree(bridge.to_jax_tree(module.state_dict(), kind), jax.device_get(tree))
    bad = {**jax.device_get(tree), "stray": {"q": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="no rule"):
        bridge.from_jax_tree(bad, kind)


TINY_CONFIGS = {
    "dinov2": lambda m: ("DinoConfig", ("v2_small", "v2_base"), m.DinoConfig.tiny),
    "dinov1": lambda m: ("DinoConfig", ("v1_vits8",),
                         lambda: m.DinoConfig.tiny(layerscale=False)),
    "u2net": lambda m: ("U2NetConfig", ("u2netp", "u2net"), m.U2NetConfig.tiny),
}


@pytest.mark.parametrize("family", ["clip", "dinov2", "dinov1", "vgg19", "lpips", "u2net"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_cli_baseline_families_match_jax(family, dtype, tmp_path, monkeypatch):
    """``cli.convert`` of each baseline family from a safetensors file of published names:
    the JAX CLI's keys and bytes, with both CLIs' configs cut to tiny widths, and the port's
    ``.npz`` loads through the bridge into its model."""
    from diffsim_tpu_torch.models import clip_text as tct
    from diffsim_tpu_torch.models import clip_vision as tcv

    rng = np.random.default_rng(91)
    argv, files = [family], {}
    if family == "clip":
        for m in (jcv, tcv):
            monkeypatch.setattr(m.CLIPVisionConfig, "b32", staticmethod(m.CLIPVisionConfig.tiny))
        for m in (jct, tct):  # the CLI builds the 512-wide text config inline: keep 2 layers
            real = m.CLIPTextConfig
            monkeypatch.setattr(m, "CLIPTextConfig",
                                lambda real=real, **kw: real(**{**kw, "layers": 2}))
        files["model"] = clip_sd(rng)
    elif family in ("dinov2", "dinov1", "u2net"):
        for m in ((jd, td) if family != "u2net" else (ju, tu)):
            cls_name, names, tiny = TINY_CONFIGS[family](m)
            for name in names:
                monkeypatch.setattr(getattr(m, cls_name), name, staticmethod(tiny))
        if family == "dinov2":
            files["model"] = dinov2_sd(jd.DinoConfig.tiny(), rng)
            argv += ["--size", "base"]
        elif family == "dinov1":
            files["model"] = dino_v1_sd(jd.DinoConfig.tiny(layerscale=False), rng)
        else:
            files["model"] = {k: v.numpy() for k, v in
                              _mirror_u2net(ju.U2NetConfig.tiny()).state_dict().items()}
    else:
        for m in (jvgg, tvgg):
            monkeypatch.setattr(m, "VGG19_CFG", SMALL_VGG)
            monkeypatch.setattr(m, "VGG16_CFG", SMALL_VGG)
        if family == "vgg19":
            files["model"] = vgg_features_sd(SMALL_VGG, rng)
        else:
            files["model"] = lpips_sd(rng)
            files["vgg"] = vgg_features_sd(SMALL_VGG, rng)
    for name, sd in files.items():
        path = str(tmp_path / f"{name}.safetensors")
        st_save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, path)
        argv += [f"--{name}", path]
    argv += ["--dtype", dtype]
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    tcli.main(argv + ["--out", ours])
    jcli.main(argv + ["--out", ref])
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    models = {  # the families whose synthetic widths are a model's: load the .npz into it
        "dinov2": (lambda: td.Dino(td.DinoConfig.tiny()), "dino"),
        "dinov1": (lambda: td.Dino(td.DinoConfig.tiny(layerscale=False)), "dino"),
        "vgg19": (lambda: tvgg.VGG(SMALL_VGG), "vgg"),
        "u2net": (lambda: tu.U2Net(tu.U2NetConfig.tiny()), "u2net"),
    }
    if family in models:
        _built(*models[family][:1], store.load_params(ours), models[family][1])

