"""The PyTorch port's weight bridge (diffsim_tpu_torch/convert/bridge.py) against the JAX
package's own init trees: strict in both directions, layouts round-trip exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.convert import store as jax_store
from diffsim_tpu.models import clip_text as jclip
from diffsim_tpu.models import dit as jdit
from diffsim_tpu.models import unet as junet
from diffsim_tpu.models import vae as jvae
from diffsim_tpu_torch.convert import bridge, store
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.dit import DiT, DiTConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig


# SDXL's tower 2 at tiny width: gelu and a bias-free text projection
TEXT2 = dict(vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64, act="gelu",
             projection_dim=16)


def _jax_tree(case):
    key = jax.random.PRNGKey(3)
    if case == "unet":
        return jax.device_get(junet.init(key, junet.UNetConfig.tiny(), jnp.float32))
    if case == "unet_xl":
        return jax.device_get(junet.init(key, junet.UNetConfig.tiny_xl(64), jnp.float32))
    if case == "vae":
        return jax.device_get(jvae.encoder_init(key, jvae.VAEConfig.tiny(), jnp.float32))
    if case == "text2":
        return jax.device_get(jclip.init(key, jclip.CLIPTextConfig(**TEXT2), jnp.float32))
    if case == "dit":
        return jax.device_get(jdit.init(key, jdit.DiTConfig.tiny(), jnp.float32))
    return jax.device_get(jclip.init(key, jclip.CLIPTextConfig.tiny(), jnp.float32))


_FACTORIES = {
    "unet": lambda: UNet(UNetConfig.tiny()),
    "unet_xl": lambda: UNet(UNetConfig.tiny_xl(64)),
    "vae": lambda: Encoder(VAEConfig.tiny()),
    "text": lambda: CLIPText(CLIPTextConfig.tiny()),
    "text2": lambda: CLIPText(CLIPTextConfig(**TEXT2)),
    "dit": lambda: DiT(DiTConfig.tiny()),
}
_KINDS = {"unet_xl": "unet"}  # the bridge kind of each case, where it differs from the name


def _built(case, tree):
    with torch.device("meta"):
        module = _FACTORIES[case]()
    return bridge.load(module, tree, _KINDS.get(case, case), "cpu", torch.float32)


@pytest.mark.parametrize("kind", ["unet", "vae", "text", "text2", "unet_xl", "dit"])
def test_bridge_round_trips_tiny_init_trees_strictly(kind):
    """SD-1.5's three trees, SDXL's two new shapes (the bigG-style tower, the UNet with
    linear projections and the text_time addition embedding) and DiT's (its pos_embed and
    y_embedder tables, the dense patch embedding)."""
    tree = _jax_tree(kind)
    flat = jax_store._flatten(tree)
    module = _built(kind, tree)
    state = module.state_dict()
    assert len(state) == len(flat)  # every leaf consumed, every parameter provided
    assert not any(t.is_meta for t in state.values())
    back = store._flatten(bridge.to_jax_tree(state, _KINDS.get(kind, kind)))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr)


@pytest.mark.parametrize("kind", ["unet", "vae", "text", "text2", "dit"])
def test_bridge_rejects_an_unknown_leaf(kind):
    tree = _jax_tree(kind)
    tree["surplus"] = {"gamma": np.zeros((3,), np.float32)}
    with pytest.raises(KeyError, match="surplus"):
        bridge.from_jax_tree(tree, kind)


def test_bridge_rejects_a_missing_leaf():
    tree = _jax_tree("vae")
    del tree["quant_conv"]["b"]
    with pytest.raises(RuntimeError, match="quant_conv.bias"):
        _built("vae", tree)


def test_bridge_rejects_a_wrong_shape():
    tree = _jax_tree("vae")
    tree["conv_in"]["w"] = np.zeros((3, 3, 3, 7), np.float32)
    with pytest.raises(RuntimeError, match="conv_in.weight"):
        _built("vae", tree)


def test_store_reads_the_jax_store_format(tmp_path):
    tree = _jax_tree("text")
    path = str(tmp_path / "text.npz")
    jax_store.save_params(path, tree)
    loaded = store.load_params(path)
    assert sorted(store._flatten(loaded)) == sorted(jax_store._flatten(tree))
    module = _built("text", loaded)
    np.testing.assert_array_equal(module.layers[1].fc1.weight.detach().numpy(),
                                  np.asarray(tree["layers"][1]["fc1"]["w"]).T)
