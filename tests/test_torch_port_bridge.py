"""The PyTorch port's weight bridge (diffsim_tpu_torch/convert/bridge.py) against the JAX
package's own init trees: strict in both directions, layouts round-trip exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.convert import store as jax_store
from diffsim_tpu.models import clip_text as jclip
from diffsim_tpu.models import unet as junet
from diffsim_tpu.models import vae as jvae
from diffsim_tpu_torch.convert import bridge, store
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig


def _jax_tree(kind):
    key = jax.random.PRNGKey(3)
    if kind == "unet":
        return jax.device_get(junet.init(key, junet.UNetConfig.tiny(), jnp.float32))
    if kind == "vae":
        return jax.device_get(jvae.encoder_init(key, jvae.VAEConfig.tiny(), jnp.float32))
    return jax.device_get(jclip.init(key, jclip.CLIPTextConfig.tiny(), jnp.float32))


_FACTORIES = {
    "unet": lambda: UNet(UNetConfig.tiny()),
    "vae": lambda: Encoder(VAEConfig.tiny()),
    "text": lambda: CLIPText(CLIPTextConfig.tiny()),
}


def _built(kind, tree):
    with torch.device("meta"):
        module = _FACTORIES[kind]()
    return bridge.load(module, tree, kind, "cpu", torch.float32)


@pytest.mark.parametrize("kind", ["unet", "vae", "text"])
def test_bridge_round_trips_tiny_init_trees_strictly(kind):
    tree = _jax_tree(kind)
    flat = jax_store._flatten(tree)
    module = _built(kind, tree)
    state = module.state_dict()
    assert len(state) == len(flat)  # every leaf consumed, every parameter provided
    assert not any(t.is_meta for t in state.values())
    back = store._flatten(bridge.to_jax_tree(state, kind))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr)


@pytest.mark.parametrize("kind", ["unet", "vae", "text"])
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
