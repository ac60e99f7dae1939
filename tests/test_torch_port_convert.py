"""The port's standalone checkpoint import (diffsim_tpu_torch/convert/, cli/convert.py) against
the JAX package's converters on the CPU: the same trees leaf for leaf from the synthetic state
dicts of tests/test_convert_diffusion.py and from the torch fixtures' diffusers-named weights, a
numpy-only safetensors reader equal to the ``safetensors`` package, bf16 ``.npz`` leaves byte for
byte the JAX converter's, the convert CLI end to end into ``--weights``, and the bf16 load fault
(ROADMAP Queue 3 item 1): a ``.npz`` written the JAX converter's way now loads in the port."""

import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save_file as st_save_file
from safetensors.torch import save_file as st_save_torch

from diffsim_tpu.cli import convert as jcli
from diffsim_tpu.convert import diffusion_import as JDI
from diffsim_tpu.convert import save_params as jax_save_params
from diffsim_tpu.convert import torch_import as JTI
from diffsim_tpu.models import clip_text as jclip
from diffsim_tpu.models import dit as jdit
from diffsim_tpu.models import unet as junet
from diffsim_tpu.models import vae as jvae
from diffsim_tpu_torch.cli import convert as tcli
from diffsim_tpu_torch.cli.args import arg_parse
from diffsim_tpu_torch.convert import bridge, store
from diffsim_tpu_torch.convert import diffusion_import as DI
from diffsim_tpu_torch.convert import torch_import as TI
from diffsim_tpu_torch.metrics import registry
from diffsim_tpu_torch.models import clip_text, dit, unet, vae
from tests.test_convert_diffusion import synth_dit_sd, synth_unet_sd, synth_vae_sd

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_tree(ours, ref):
    """Equal trees: the same paths, and every leaf equal in dtype, shape and value."""
    a, b = store._flatten(ours), store._flatten(jax.device_get(ref))
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        assert np.array_equal(a[key], b[key]), key


def synth_clip_text_sd(cfg, prefix="text_model.", projection=True) -> dict:
    """An HF-named CLIPTextModel state dict for ``cfg``, seeded."""
    rng = np.random.default_rng(1)
    sd = {}

    def t(name, *shape):
        sd[name] = rng.standard_normal(shape).astype(np.float32)

    h, m = cfg.hidden, cfg.intermediate
    t(f"{prefix}embeddings.token_embedding.weight", cfg.vocab_size, h)
    t(f"{prefix}embeddings.position_embedding.weight", 77, h)
    for i in range(cfg.layers):
        base = f"{prefix}encoder.layers.{i}"
        for norm in ("layer_norm1", "layer_norm2"):
            t(f"{base}.{norm}.weight", h)
            t(f"{base}.{norm}.bias", h)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t(f"{base}.self_attn.{proj}.weight", h, h)
            t(f"{base}.self_attn.{proj}.bias", h)
        t(f"{base}.mlp.fc1.weight", m, h)
        t(f"{base}.mlp.fc1.bias", m)
        t(f"{base}.mlp.fc2.weight", h, m)
        t(f"{base}.mlp.fc2.bias", h)
    t(f"{prefix}final_layer_norm.weight", h)
    t(f"{prefix}final_layer_norm.bias", h)
    if projection:
        t("text_projection.weight", cfg.projection_dim or h, h)
    return sd


UNETS = {"sd15": (junet.UNetConfig.tiny(64), unet.UNetConfig.tiny(64)),
         "sdxl": (junet.UNetConfig.tiny_xl(64), unet.UNetConfig.tiny_xl(64))}


@pytest.mark.parametrize("family", sorted(UNETS))
def test_unet_converter_matches_jax_on_synthetic_state_dicts(family):
    jcfg, tcfg = UNETS[family]
    sd = synth_unet_sd(jcfg)
    _assert_same_tree(DI.convert_sd_unet(sd, tcfg), JDI.convert_sd_unet(sd, jcfg))


def test_vae_converter_matches_jax_on_synthetic_state_dicts():
    sd = synth_vae_sd(jvae.VAEConfig.tiny())
    _assert_same_tree(DI.convert_vae(sd, vae.VAEConfig.tiny()),
                      JDI.convert_vae(sd, jvae.VAEConfig.tiny()))


@pytest.mark.parametrize("with_pos_embed", [True, False])
def test_dit_converter_matches_jax_on_synthetic_state_dicts(with_pos_embed):
    """Without ``pos_embed`` both fall back to their own sin-cos table: equal bit for bit."""
    sd = synth_dit_sd(jdit.DiTConfig.tiny())
    if not with_pos_embed:
        del sd["pos_embed"]
    _assert_same_tree(DI.convert_dit(sd, dit.DiTConfig.tiny()),
                      JDI.convert_dit(sd, jdit.DiTConfig.tiny()))


@pytest.mark.parametrize("prefix,projection", [("text_model.", False), ("", True),
                                               ("text_model.", True)])
def test_clip_text_converter_matches_jax(prefix, projection):
    cfg = clip_text.CLIPTextConfig(vocab_size=1000, hidden=32, layers=2, heads=2,
                                   intermediate=64, projection_dim=16)
    sd = synth_clip_text_sd(cfg, prefix, projection)
    _assert_same_tree(TI.convert_clip_text(sd, cfg),
                      JTI.convert_clip_text(sd, jclip.CLIPTextConfig(
                          vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64,
                          projection_dim=16)))


def test_patch_conv_to_dense_matches_jax():
    w = np.random.default_rng(2).standard_normal((8, 4, 2, 2)).astype(np.float32)
    out = TI._patch_conv_to_dense(w)
    assert out.shape == (16, 8) and np.array_equal(out, JTI._patch_conv_to_dense(w))


def _fixture_sd(name, prefix):
    with np.load(os.path.join(FIXTURES, name)) as f:
        return {k[len(prefix):]: f[k] for k in f.files if k.startswith(prefix)}


FIXTURE_CASES = {
    "sd15_unet": ("torch_parity_tiny.npz", "sd::unet::",
                  lambda sd: DI.convert_sd_unet(sd, unet.UNetConfig.tiny()),
                  lambda sd: JDI.convert_sd_unet(sd, junet.UNetConfig.tiny())),
    "sd15_vae": ("torch_parity_tiny.npz", "sd::vae::",
                 lambda sd: DI.convert_vae(sd, vae.VAEConfig.tiny()),
                 lambda sd: JDI.convert_vae(sd, jvae.VAEConfig.tiny())),
    "sdxl_unet": ("torch_parity_xl_dit.npz", "xl::unet::",
                  lambda sd: DI.convert_sd_unet(sd, unet.UNetConfig.tiny_xl(64)),
                  lambda sd: JDI.convert_sd_unet(sd, junet.UNetConfig.tiny_xl(64))),
    "vae": ("torch_parity_xl_dit.npz", "vae::",
            lambda sd: DI.convert_vae(sd, vae.VAEConfig.tiny()),
            lambda sd: JDI.convert_vae(sd, jvae.VAEConfig.tiny())),
    "dit": ("torch_parity_xl_dit.npz", "dit::model::",
            lambda sd: DI.convert_dit(sd, dit.DiTConfig.tiny(input_size=16, num_classes=10)),
            lambda sd: JDI.convert_dit(sd, jdit.DiTConfig.tiny(input_size=16, num_classes=10))),
}


@pytest.mark.parametrize("case", sorted(FIXTURE_CASES))
def test_converters_match_jax_on_the_torch_fixtures(case):
    """The diffusers / DiT-named weights of the committed torch fixtures, strictly (every key
    consumed)."""
    name, prefix, ours, ref = FIXTURE_CASES[case]
    sd = _fixture_sd(name, prefix)
    _assert_same_tree(ours(sd), ref(sd))


def test_converter_strict_mode_rejects_leftovers():
    sd = synth_dit_sd(jdit.DiTConfig.tiny())
    sd["some.unknown.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        DI.convert_dit(sd, dit.DiTConfig.tiny())
    DI.convert_dit(sd, dit.DiTConfig.tiny(), strict=False)


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_safetensors_reader_equals_the_package(tmp_path, dtype):
    rng = np.random.default_rng(3)
    tensors = {"a.weight": rng.standard_normal((5, 3)).astype(dtype),
               "a.bias": rng.standard_normal((5,)).astype(dtype),
               "ids": np.arange(12, dtype=np.int64).reshape(3, 4),
               "empty": np.zeros((0, 2), dtype)}
    path = str(tmp_path / "x.safetensors")
    st_save_file(tensors, path, metadata={"format": "pt"})
    ours, ref = TI.load_safetensors(path), st_load_file(path)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype and np.array_equal(ours[key], ref[key]), key


def test_safetensors_reader_upcasts_bf16_bit_patterns(tmp_path):
    x = torch.randn(7, 9).to(torch.bfloat16)
    path = str(tmp_path / "bf16.safetensors")
    st_save_torch({"w": x, "v": x[0].clone()}, path)
    out = TI.load_safetensors(path)
    want = (x.view(torch.int16).numpy().view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    assert out["w"].dtype == np.float32 and np.array_equal(out["w"], want)
    assert np.array_equal(out["w"], x.float().numpy()) and np.array_equal(out["v"], want[0])


def test_safetensors_reader_rejects_a_truncated_file(tmp_path):
    path = str(tmp_path / "x.safetensors")
    st_save_file({"w": np.ones((64, 64), np.float32)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="does not match"):
        TI.load_safetensors(path)


# ---------------------------------------------------------------------------
# bf16 leaves: written as the JAX converter writes them, read back (Queue 3 item 1)
# ---------------------------------------------------------------------------


def _dit_tree():
    return JDI.convert_dit(synth_dit_sd(jdit.DiTConfig.tiny()), jdit.DiTConfig.tiny())


def test_bf16_cast_and_save_write_the_jax_converters_bytes(tmp_path):
    """cast_tree("bfloat16") + save_params in the port against the JAX CLI's path
    (ml_dtypes.bfloat16 leaves through np.savez): the same keys, dtypes and bytes per leaf,
    special values included."""
    tree = _dit_tree()
    tree["specials"] = np.array([np.nan, -np.nan, np.inf, -np.inf, 3.4e38, -0.0, 1e-45,
                                 1 + 2.0**-8, 1 + 3 * 2.0**-8], np.float32)
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    store.save_params(ours, DI.cast_tree(tree, "bfloat16"))
    with np.errstate(invalid="ignore"):
        jax_save_params(ref, JDI.cast_tree(tree, ml_dtypes.bfloat16))
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype == np.dtype("V2"), key
            assert a[key].tobytes() == b[key].tobytes(), key


def test_port_loads_a_bf16_tree_written_the_jax_converters_way(tmp_path):
    """ROADMAP Queue 3 item 1: ``np.savez`` stores ml_dtypes.bfloat16 leaves as raw ``|V2``,
    which the port's load path used to refuse (``bridge.load``: ValueError). They now load equal
    to the float32 upcast bit for bit, through ``store.load_params`` and the registry's
    ``--weights`` reader, and bridge into the module."""
    tree = _dit_tree()
    path = str(tmp_path / "bf16.npz")
    jax_save_params(path, JDI.cast_tree(tree, ml_dtypes.bfloat16))
    want = {k: np.asarray(v, ml_dtypes.bfloat16).astype(np.float32)
            for k, v in store._flatten(tree).items()}
    for loaded in (store.load_params(path), registry._load_params(path)):
        got = store._flatten(loaded)
        assert sorted(got) == sorted(want)
        for key, arr in want.items():
            assert got[key].dtype == np.float32 and got[key].tobytes() == arr.tobytes(), key
    with torch.device("meta"):
        module = dit.DiT(dit.DiTConfig.tiny())
    module = bridge.load(module, store.load_params(path), "dit", "cpu", torch.float32)
    np.testing.assert_array_equal(module.blocks[1].attn.qkv.weight.detach().numpy(),
                                  want["blocks/1/attn/qkv/w"].T)
    np.testing.assert_array_equal(module.y_embedder.detach().numpy(), want["y_embedder"])


def test_bridge_reads_raw_bf16_leaves_directly():
    leaf = np.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4), ml_dtypes.bfloat16)
    raw = leaf.view(np.uint16).view("V2")
    with torch.device("meta"):
        module = torch.nn.Linear(3, 4)
    module = bridge.load(module, {"w": raw, "b": np.zeros(4, np.float32)}, "vae", "cpu",
                         torch.float32)
    np.testing.assert_array_equal(module.weight.detach().numpy(), leaf.astype(np.float32).T)


# ---------------------------------------------------------------------------
# the convert CLI
# ---------------------------------------------------------------------------

TINY_DIT = dict(input_size=16, num_classes=1000)  # the registry's --model_scale tiny at 32 px


TINY_TEXT2 = dict(vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64,
                  projection_dim=16)  # the registry's SDXL tower 2 of --model_scale tiny


@pytest.fixture()
def tiny_configs(monkeypatch):
    """Both CLIs' full-size config constructors swapped for the registry's tiny ones."""
    for d, u, v, c in ((dit, unet, vae, clip_text), (jdit, junet, jvae, jclip)):
        monkeypatch.setattr(d.DiTConfig, "xl2", staticmethod(
            lambda input_size=32, d=d, **kw: d.DiTConfig.tiny(**TINY_DIT)))
        monkeypatch.setattr(u.UNetConfig, "sd15", staticmethod(u.UNetConfig.tiny))
        monkeypatch.setattr(u.UNetConfig, "sdxl",
                            staticmethod(lambda u=u: u.UNetConfig.tiny_xl(64)))
        for name in ("sd", "sdxl"):
            monkeypatch.setattr(v.VAEConfig, name, staticmethod(v.VAEConfig.tiny))
        monkeypatch.setattr(c.CLIPTextConfig, "sd15", staticmethod(c.CLIPTextConfig.tiny))
        monkeypatch.setattr(c.CLIPTextConfig, "sdxl_big_g", staticmethod(
            lambda c=c: c.CLIPTextConfig(**TINY_TEXT2)))


@pytest.fixture()
def checkpoints(tmp_path):
    """A train-format DiT checkpoint ({"ema": state dict}, torch.save) and a VAE safetensors
    file, tiny and synthetic."""
    sd = synth_dit_sd(jdit.DiTConfig.tiny(**TINY_DIT))
    ckpt = str(tmp_path / "dit.pt")
    torch.save({"ema": {k: torch.from_numpy(v) for k, v in sd.items()}, "opt": {}}, ckpt)
    vae_path = str(tmp_path / "vae.safetensors")
    st_save_file(synth_vae_sd(jvae.VAEConfig.tiny()), vae_path)
    return ckpt, vae_path


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_cli_dit_matches_jax_and_scores_through_weights(tiny_configs, checkpoints,
                                                                tmp_path, dtype):
    """``cli.convert dit`` writes the JAX CLI's keys and bytes, and its ``.npz`` scores
    through ``build_metric(--metric dit --weights ...)`` on the CPU."""
    ckpt, vae_path = checkpoints
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    argv = ["dit", "--ckpt", ckpt, "--vae", vae_path, "--image_size", "32", "--dtype", dtype]
    tcli.main(argv + ["--out", ours])
    jcli.main(argv + ["--out", ref])
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        assert {k.split("/")[0] for k in a.files} == {"dit", "vae", "vae_decoder"}
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    args = arg_parse(["--metric", "dit", "--weights", ours, "--model_scale", "tiny",
                      "--image_size", "32", "--image_path", "x", "--target_layer", "1",
                      "--target_step", "600"])
    adapter = registry.build_metric(args, device="cpu")
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8) for _ in range(2))
    scores = adapter.score_pairs(a, b, ["", ""])
    assert scores.shape == (2,) and np.isfinite(scores).all()
    tree = store.load_params(ours)
    np.testing.assert_array_equal(adapter.scorer.dit.blocks[0].attn.proj.weight.numpy(),
                                  tree["dit"]["blocks"][0]["attn"]["proj"]["w"].T)


def test_convert_cli_needs_no_jax_safetensors_or_ml_dtypes(checkpoints, tmp_path):
    """``python -m diffsim_tpu_torch.cli.convert`` in a process where importing jax,
    safetensors or ml_dtypes raises writes the same ``.npz`` as in this process."""
    import subprocess
    import sys

    ckpt, vae_path = checkpoints
    argv = ["dit", "--ckpt", ckpt, "--vae", vae_path, "--image_size", "32"]
    code = ("import runpy, sys\n"
            "for name in ('jax', 'safetensors', 'ml_dtypes'):\n"
            "    sys.modules[name] = None\n"
            "from diffsim_tpu_torch.models import dit, vae\n"
            "dit.DiTConfig.xl2 = staticmethod(lambda input_size=32, **kw: dit.DiTConfig.tiny("
            "input_size=16, num_classes=1000))\n"
            "vae.VAEConfig.sd = staticmethod(vae.VAEConfig.tiny)\n"
            "runpy.run_module('diffsim_tpu_torch.cli.convert', run_name='__main__', "
            "alter_sys=True)\n")
    out = str(tmp_path / "blocked.npz")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code, *argv, "--out", out], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    ref = str(tmp_path / "ref.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dit.DiTConfig, "xl2", staticmethod(
            lambda input_size=32, **kw: dit.DiTConfig.tiny(**TINY_DIT)))
        mp.setattr(vae.VAEConfig, "sd", staticmethod(vae.VAEConfig.tiny))
        tcli.main(argv + ["--out", ref])
    with np.load(out) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_convert_cli_sd_families_match_jax_and_load_through_weights(tiny_configs, tmp_path,
                                                                    family):
    """``cli.convert sd15|sdxl`` from safetensors files: the JAX CLI's keys and bytes, and the
    port's ``--weights`` takes the ``.npz`` (the VAE decoder it also holds is dropped)."""
    files = {}
    sds = {"unet": synth_unet_sd(junet.UNetConfig.tiny() if family == "sd15"
                                 else junet.UNetConfig.tiny_xl(64)),
           "vae": synth_vae_sd(jvae.VAEConfig.tiny()),
           "text": synth_clip_text_sd(clip_text.CLIPTextConfig.tiny(), projection=False)}
    if family == "sdxl":
        sds["text2"] = synth_clip_text_sd(clip_text.CLIPTextConfig(**TINY_TEXT2))
    argv = [family]
    for name, sd in sds.items():
        files[name] = str(tmp_path / f"{name}.safetensors")
        st_save_file(sd, files[name])
        argv += [f"--{name}", files[name]]
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    tcli.main(argv + ["--out", ours])
    jcli.main(argv + ["--out", ref])
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    metric, layer = ("diffsim", ["0"]) if family == "sd15" else ("diffsim_xl", ["0", "1", "1"])
    args = arg_parse(["--metric", metric, "--weights", ours, "--model_scale", "tiny",
                      "--image_size", "32", "--image_path", "x", "--allow_hash_tokenizer",
                      "--target_layer", *layer])
    adapter = registry.build_metric(args, device="cpu")
    pix = np.random.default_rng(5).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    assert np.isfinite(adapter.score_pairs(pix, pix[:, ::-1].copy(), ["a cat"])).all()

