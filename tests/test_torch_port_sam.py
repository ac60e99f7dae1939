"""The port's SAM against the JAX package's, in float32 on the CPU: the image encoder, the dense
positions, the point encoding, the two-way decoder and ``predict`` at
``SamConfig.tiny()`` on bridged random weights; the relative-position resize growing and
shrinking against ``jax.image.resize``; ``convert_sam`` leaf for leaf (tiny, and the full ViT-B
layout on zeros); ``infer_config`` for every variant; ``SamMasking``'s RGBA mattes at two aspect
ratios; the CLI's ``--use_mask --sam_weights`` masks against the JAX CLI's, and a ``cute`` run
with them. Inputs come from seeded numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffsim_tpu.cli import main as jmain
from diffsim_tpu.convert.sam_import import convert_sam as j_convert_sam
from diffsim_tpu.metrics import sam_masking as jsm
from diffsim_tpu.models import sam as js
from diffsim_tpu.runtime import runner as jrunner
from diffsim_tpu_torch.cli import convert as tcli
from diffsim_tpu_torch.cli.main import run_benchmark
from diffsim_tpu_torch.convert import bridge, store
from diffsim_tpu_torch.convert.sam_import import convert_sam
from diffsim_tpu_torch.metrics import sam_masking as tsm
from diffsim_tpu_torch.models import sam as ts
from diffsim_tpu_torch.runtime import runner as trunner
from tests import fixtures
from tools.torch_sam import Sam as MirrorSam

# no looser than tests/test_sam.py's own against the torch mirror (2e-4 on embeddings and IoU,
# 2e-3 on masks): float32 on both sides, the same math
TOL = dict(rtol=1e-5, atol=1e-5)
MASK_TOL = 1e-5  # |logit| within which a resampled logit's sign may differ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(JAX tree, port module) at tiny scale with one seeded numpy draw of every leaf."""
    cfg = js.SamConfig.tiny()
    tree = jax.device_get(js.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tree = jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(np.shape(x)) * 0.3).astype(np.float32) for x in leaves])
    with torch.device("meta"):
        module = ts.Sam(ts.SamConfig.tiny())
    return tree, bridge.load(module, tree, "sam", "cpu", torch.float32).eval()


def _pixels(seed, b=2, size=32):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _points():
    coords = np.asarray([[[10.0, 20.0], [5.0, 7.0], [3.0, 30.0]],
                         [[31.0, 0.0], [16.0, 16.0], [0.0, 0.0]]], np.float32)
    labels = np.asarray([[1, 0, -1], [2, 3, 1]], np.int32)
    return coords, labels


def _jax_part(tree, cfg, part):
    pix = _pixels(1)
    coords, labels = _points()
    if part == "encoder":
        return js.encoder_apply(tree["image_encoder"], jnp.asarray(pix), cfg)
    if part == "dense_pe":
        return js.dense_pe(tree["prompt_encoder"], cfg.grid)
    if part == "points":
        return js.encode_points(tree["prompt_encoder"], cfg, jnp.asarray(coords),
                                jnp.asarray(labels))
    if part == "decoder":
        rng = np.random.default_rng(3)
        embed = rng.standard_normal((2, cfg.grid, cfg.grid, cfg.prompt_dim)).astype(np.float32)
        sparse = rng.standard_normal((2, 3, cfg.prompt_dim)).astype(np.float32)
        pe = js.dense_pe(tree["prompt_encoder"], cfg.grid)
        return js.decoder_apply(tree["mask_decoder"], cfg, jnp.asarray(embed), pe,
                                jnp.asarray(sparse))
    return js.predict(tree, cfg, jnp.asarray(pix), jnp.asarray(coords), jnp.asarray(labels),
                      multimask=part == "predict_multimask")


def _port_part(module, part):
    cfg = module.cfg
    pix = torch.from_numpy(_pixels(1))
    coords, labels = (torch.from_numpy(a) for a in _points())
    labels = labels.long()
    pe = module.prompt_encoder
    with torch.no_grad():
        if part == "encoder":
            return module.image_encoder(pix)
        if part == "dense_pe":
            return pe.dense_pe(cfg.grid)
        if part == "points":
            return pe.encode_points(coords, labels)
        if part == "decoder":
            rng = np.random.default_rng(3)
            embed = rng.standard_normal((2, cfg.grid, cfg.grid, cfg.prompt_dim)).astype(np.float32)
            sparse = rng.standard_normal((2, 3, cfg.prompt_dim)).astype(np.float32)
            return module.mask_decoder(torch.from_numpy(embed), pe.dense_pe(cfg.grid),
                                       torch.from_numpy(sparse))
        return module.predict(pix, coords, labels, multimask=part == "predict_multimask")


@pytest.mark.parametrize("part", ["encoder", "dense_pe", "points", "decoder",
                                  "predict_multimask", "predict_single"])
def test_sam_parts_match_jax(tiny, part):
    """Each part of the port's SAM equals the JAX SAM's on the same weights and inputs: the
    decoder's and ``predict``'s mask logits and IoU predictions both."""
    tree, module = tiny
    ref = _jax_part(tree, js.SamConfig.tiny(), part)
    ours = _port_part(module, part)
    refs, outs = (ref, ours) if isinstance(ref, tuple) else ((ref,), (ours,))
    for r, o in zip(refs, outs):
        r = np.asarray(r)
        assert o.shape == r.shape and o.dtype == torch.float32
        assert np.abs(r).max() > 0.1  # the weights' scale reaches the output
        np.testing.assert_allclose(o.numpy(), r, **TOL)


@pytest.mark.parametrize("stored, size", [(7, 5), (5, 9), (9, 3), (13, 4), (27, 8), (9, 5)])
def test_rel_pos_resize_matches_jax_image_resize(stored, size):
    """``get_rel_pos`` resizes a stored table of another length as ``jax.image.resize(...,
    "linear")`` does, growing (7 -> 9, 5 -> 17) and shrinking (antialiased: 9 -> 5, 13 -> 7,
    27 -> 15), and takes a table of the right length as it is (9 at size 5)."""
    table = np.random.default_rng(stored * 100 + size).standard_normal((stored, 8))
    table = table.astype(np.float32)
    ref = np.asarray(js._get_rel_pos(size, jnp.asarray(table)))
    ours = ts.get_rel_pos(size, torch.from_numpy(table))
    assert ours.shape == (size, size, 8)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)  # tests/test_sam.py's


def _mirror(cfg, **kw):
    return MirrorSam(image_size=cfg.image_size, patch=cfg.patch, encoder_dim=cfg.encoder_dim,
                     encoder_depth=cfg.encoder_depth, encoder_heads=cfg.encoder_heads,
                     global_attn=cfg.global_attn, window=cfg.window, prompt_dim=cfg.prompt_dim,
                     decoder_heads=cfg.decoder_heads, decoder_depth=cfg.decoder_depth,
                     decoder_mlp=cfg.decoder_mlp)


def _same_tree(ours, ref):
    a, b = store._flatten(ours), store._flatten(ref)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].shape == b[key].shape and np.array_equal(a[key], b[key]), key


def test_convert_sam_matches_jax_tiny():
    """``convert_sam`` of a published-layout state dict (the repo's torch mirror, seeded) gives
    the JAX converter's tree leaf for leaf, and refuses a key it does not consume."""
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in _mirror(js.SamConfig.tiny()).state_dict().items()}
    rng = np.random.default_rng(1)
    sd = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in sd.items()}
    ours = convert_sam(sd, ts.SamConfig.tiny())
    _same_tree(ours, j_convert_sam(sd, js.SamConfig.tiny()))
    with pytest.raises(ValueError, match="unconsumed"):
        convert_sam({**sd, "extra.weight": np.zeros(1)}, ts.SamConfig.tiny())


def test_convert_sam_matches_jax_on_the_full_vit_b_layout():
    """The full published sam_vit_b layout (zero-stride zeros): the same tree as the JAX
    converter, and every leaf lands on a parameter of the port's ViT-B with its shape."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in _mirror(js.SamConfig.vit_b()).state_dict().items()}
        params = {k: tuple(v.shape) for k, v in ts.Sam(ts.SamConfig.vit_b()).state_dict().items()}
    sd = {k: np.broadcast_to(np.float32(0), s) for k, s in shapes.items()}
    ours = convert_sam(sd, ts.SamConfig.vit_b())
    _same_tree(ours, j_convert_sam(sd, js.SamConfig.vit_b()))
    placed = dict(bridge._convert(path, leaf, "sam")
                  for path, leaf in store._flatten(ours).items())
    assert {k: v.shape for k, v in placed.items()} == params
    assert tsm.infer_config(ours) == ts.SamConfig.vit_b()


@pytest.mark.parametrize("variant", ["vit_b", "vit_l", "vit_h", "tiny"])
def test_infer_config_matches_jax(variant):
    """The config recovered from a tree's shapes (zero-stride leaves at each variant's widths)
    equals the JAX package's, field for field."""
    cfg = getattr(js.SamConfig, variant)()
    shapes = jax.eval_shape(lambda: js.init(jax.random.PRNGKey(0), cfg))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    ours, ref = tsm.infer_config(tree), jsm.infer_config(tree)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    if variant != "tiny":  # the tiny config's 2 decoder heads are not in its shapes
        assert ours == getattr(ts.SamConfig, variant)()


def test_bridge_round_trips_the_sam_tree(tiny):
    tree, module = tiny
    _same_tree(bridge.to_jax_tree(module.state_dict(), "sam"), tree)
    with pytest.raises(KeyError, match="no rule"):
        bridge.from_jax_tree({**tree, "stray": {"q": np.zeros(3, np.float32)}}, "sam")


@pytest.mark.parametrize("size", [(48, 40), (24, 56)])
def test_sam_masking_matches_jax(tiny, size):
    """``SamMasking`` on a landscape and a portrait image: the best-IoU logits equal JAX's, and
    the RGBA matte equals JAX's except where the resampled logit is within MASK_TOL of 0."""
    tree, _ = tiny
    cfg = js.SamConfig.tiny()
    ours, ref = tsm.SamMasking(tree, ts.SamConfig.tiny(), device="cpu"), jsm.SamMasking(tree, cfg)
    rng = np.random.default_rng(sum(size))
    img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), np.uint8))
    pixels, coords, labels, (nw, nh) = ours.inputs(img)
    assert max(nw, nh) == cfg.image_size
    logits = ours.best_logits(pixels, coords, labels)
    ref_logits = np.asarray(ref._fn(ref.params, jnp.asarray(pixels), jnp.asarray(coords),
                                    jnp.asarray(labels.astype(np.int32))))[0]
    np.testing.assert_allclose(logits, ref_logits, **TOL)
    a, b = np.asarray(ours(img)), np.asarray(ref(img))
    assert a.shape == b.shape == (size[1], size[0], 4)
    assert np.array_equal(a[..., :3], b[..., :3])
    crop = np.ascontiguousarray(ref_logits[: round(nh / 4), : round(nw / 4)])
    resampled = np.asarray(Image.fromarray(crop, "F").resize(size, Image.BILINEAR))
    differ = a[..., 3] != b[..., 3]
    assert not differ[np.abs(resampled) > MASK_TOL].any()
    assert 0 < (a[..., 3] > 0).mean() < 1  # a matte with both sides


@pytest.fixture(scope="module")
def sam_npz(tiny, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sam") / "sam.npz")
    store.save_params(path, tiny[0])
    return path


@pytest.fixture(scope="module")
def cute(tmp_path_factory):
    return fixtures.make_cute(str(tmp_path_factory.mktemp("bench")))


def _argv(cute, npz, *extra):
    return ["--preset", "cute", "--image_path", cute, "--image_size", "32", "--model_scale",
            "tiny", "--use_mask", "--sam_weights", npz, *extra]


def test_cli_sam_mask_fn_matches_the_jax_cli(cute, sam_npz, monkeypatch):
    """``--use_mask --sam_weights``: the masks the port's CLI hands the runner equal the JAX
    CLI's on the same ``.npz`` (both infer the config; the runner is stubbed after planning)."""
    got = {}

    def capture(name):
        def run_2afc(comparisons, *a, mask_fn=None, **kw):
            got[name] = (comparisons, mask_fn)
            raise SystemExit
        return run_2afc

    monkeypatch.setattr(trunner, "run_2afc", capture("port"))
    monkeypatch.setattr(jrunner, "run_2afc", capture("jax"))
    with pytest.raises(SystemExit):
        run_benchmark("cute", _argv(cute, sam_npz), device="cpu")
    with pytest.raises(SystemExit):
        jmain.run_benchmark("cute", _argv(cute, sam_npz))
    comparisons = got["port"][0]
    paths = sorted({c.a for c in comparisons} | {c.b for c in comparisons})[:6]
    masks = [(got["port"][1](p), got["jax"][1](p)) for p in paths]
    for ours, ref in masks:
        assert ours.shape == ref.shape == (1, 32, 32) and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
    assert any(0 < ours.mean() < 1 for ours, _ in masks)


def test_cute_with_sam_masks_runs_on_the_cpu(cute, sam_npz, capsys):
    report, (adapter,) = run_benchmark("cute", _argv(cute, sam_npz, "--batch_size", "16"),
                                       device="cpu")
    assert report.total == 40 and adapter.wants_masks
    assert "[use_mask] generating masks with SAM (center-point prompt)" in capsys.readouterr().out


def test_convert_cli_sam_matches_the_jax_cli(tmp_path, monkeypatch):
    """``cli.convert sam`` on a ``torch.save`` checkpoint: the JAX CLI's ``.npz`` byte for byte,
    the variant picked by the embedding width (ViT-B's cut to tiny in both CLIs)."""
    from diffsim_tpu.cli import convert as jcli

    for m in (js, ts):
        monkeypatch.setattr(m.SamConfig, "vit_b", staticmethod(
            lambda m=m: dataclasses.replace(m.SamConfig.tiny(), encoder_dim=768,
                                            encoder_heads=12)))
    cfg = js.SamConfig.vit_b()
    torch.manual_seed(0)
    ckpt = str(tmp_path / "sam_vit_b.pth")
    torch.save(_mirror(cfg).state_dict(), ckpt)
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    tcli.main(["sam", "--model", ckpt, "--out", ours])
    jcli.main(["sam", "--model", ckpt, "--out", ref])
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    masking = tsm.SamMasking(store.load_params(ours), device="cpu")
    assert masking.cfg.encoder_dim == 768 and masking.cfg.image_size == 32
