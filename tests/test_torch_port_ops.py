"""The PyTorch port's ops (diffsim_tpu_torch/ops) against the JAX package's on the same
numpy inputs and weights, in float32 on the CPU, at atol 1e-5 (f32 rounding of the two
frameworks' op orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.ops import attention as jattn
from diffsim_tpu.ops import blocks as jb
from diffsim_tpu.ops.taps import OUTPUT, QKV
from diffsim_tpu_torch.convert import bridge
from diffsim_tpu_torch.ops import attention as tattn
from diffsim_tpu_torch.ops import blocks as tb

ATOL = 1e-5


def _randomize(tree, seed, std=0.2):
    """Every leaf of a JAX init tree redrawn N(0, std) (non-trivial norms and biases)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(
        treedef, [(rng.standard_normal(np.shape(x)) * std).astype(np.float32) for x in leaves])


def _port(factory, tree):
    with torch.device("meta"):
        module = factory()
    return bridge.load(module, tree, "unet", "cpu", torch.float32).eval().requires_grad_(False)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("c,eps", [(32, 1e-6), (64, 1e-5), (128, 1e-6)])
def test_group_norm(c, eps):
    p = _randomize(jb.norm_init(c), 0)
    x = _rand((2, 6, 5, c), 1) * 3 + 1
    ref = jb.group_norm(p, jnp.asarray(x), eps=eps)
    m = _port(lambda: tb.GroupNorm(c, eps), p)
    np.testing.assert_allclose(_nhwc(m(_nchw(x))), np.asarray(ref), atol=ATOL)


def test_layer_norm():
    p = _randomize(jb.norm_init(48), 2)
    x = _rand((2, 7, 48), 3) * 2 + 0.5
    m = _port(lambda: tb.LayerNorm(48), p)
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jb.layer_norm(p, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("kind", ["same3x3", "conv1x1", "down_symmetric", "down_asymmetric"])
def test_conv2d(kind):
    k = 1 if kind == "conv1x1" else 3
    p = _randomize(jb.conv2d_init(jax.random.PRNGKey(0), k, k, 8, 8), 4)
    x = _rand((2, 9, 10, 8), 5)
    if kind == "same3x3":
        ref, m = jb.conv2d(p, jnp.asarray(x)), _port(lambda: tb.conv3x3(8, 8), p)
    elif kind == "conv1x1":
        ref, m = jb.conv2d(p, jnp.asarray(x), padding=0), _port(lambda: tb.conv1x1(8, 8), p)
    else:
        asym = kind == "down_asymmetric"
        ref = jb.downsample(p, jnp.asarray(x), asymmetric_pad=asym)
        m = _port(lambda: tb.Downsample(8, asymmetric_pad=asym), p)
    out = _nhwc(m(_nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


def test_upsample():
    p = _randomize(jb.conv2d_init(jax.random.PRNGKey(0), 3, 3, 8, 8), 6)
    x = _rand((2, 4, 5, 8), 7)
    m = _port(lambda: tb.Upsample(8), p)
    np.testing.assert_allclose(_nhwc(m(_nchw(x))), np.asarray(jb.upsample(p, jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("cin,cout,temb", [(32, 64, True), (64, 64, False)])
def test_resnet_block(cin, cout, temb):
    eps = 1e-5 if temb else 1e-6
    p = _randomize(jb.resnet_block_init(jax.random.PRNGKey(0), cin, cout,
                                        temb_dim=16 if temb else None), 8)
    x = _rand((2, 8, 8, cin), 9)
    t = _rand((2, 16), 10) if temb else None
    ref = jb.resnet_block(p, jnp.asarray(x), None if t is None else jnp.asarray(t), eps=eps)
    m = _port(lambda: tb.ResnetBlock(cin, cout, 16 if temb else None, eps), p)
    out = m(_nchw(x), None if t is None else torch.from_numpy(t))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("attn", ["attn1", "attn2"])
def test_spatial_transformer_with_qkv_taps(attn):
    c, heads, cdim = 32, 2, 24
    p = _randomize(jb.spatial_transformer_init(jax.random.PRNGKey(0), c, heads, cdim), 11)
    x = _rand((2, 16, 16, c), 12)  # 256 tokens, hd 16: the port routes K1 and K2 (plain on CPU)
    ctx = _rand((2, 77, cdim), 13)
    tap = {"tblock": -1, "attn": attn, "capture": QKV}
    ref, ref_taps = jb.spatial_transformer(p, jnp.asarray(x), jnp.asarray(ctx), heads=heads,
                                           tap=tap)
    m = _port(lambda: tb.SpatialTransformer(c, heads, cdim), p)
    out, taps = m(_nchw(x), torch.from_numpy(ctx), tap=tap)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL)
    for name in ("q", "k", "v"):
        np.testing.assert_allclose(taps[name].numpy(), np.asarray(ref_taps[name]), atol=ATOL)
    none, early = m(_nchw(x), torch.from_numpy(ctx), tap=tap, stop=True)
    assert none is None
    for name in ("q", "k", "v"):
        np.testing.assert_array_equal(early[name].numpy(), taps[name].numpy())


@pytest.mark.parametrize("dim", [32, 320])
def test_timestep_embedding(dim):
    """XLA's and torch's f32 ``exp`` differ by up to 1 ulp on some frequencies, and the
    embedding's argument t * freq multiplies that by t: the embeddings are compared at t <= 50,
    where it stays below 1e-5. The UNet tests cover t = 401 at their own tolerance."""
    t = np.array([0.0, 1.0, 7.0, 50.0], np.float32)
    ref = jb.timestep_embedding(jnp.asarray(t), dim)
    out = tb.timestep_embedding(torch.from_numpy(t), dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 256, 32), (1, 20, 32), (3, 64, 64), (40, 64)])
def test_geglu_ff(shape):
    """(2, 256, 32) and (3, 64, 64) route to K2 in the port (plain version on the CPU) and to
    XLA math in JAX on the CPU; (1, 20, 32) routes nowhere (no row tile >= 8 divides 20);
    2-D input always takes the math path."""
    c = shape[-1]
    p = _randomize(jb.geglu_ff_init(jax.random.PRNGKey(0), c), 14)
    x = _rand(shape, 15)
    m = _port(lambda: tb.GEGLUFeedForward(c), p)
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jb.geglu_ff(p, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("q_shape,k_shape", [
    ((2, 2, 256, 40), (2, 2, 256, 40)),    # K1 route in the port (plain on the CPU)
    ((2, 2, 512, 16), (2, 2, 512, 16)),    # K1 route
    ((2, 2, 256, 40), (2, 2, 77, 40)),     # cross-attention: math path
    ((2, 2, 64, 160), (2, 2, 64, 160)),    # 8x8 mid attention: math path
    ((2, 1, 3, 2, 64, 24), (2, 1, 3, 2, 64, 24)),  # readout-style 5+-d: math path
])
def test_sdpa(q_shape, k_shape):
    q = _rand(q_shape, 16)
    k = _rand(k_shape, 17)
    v = _rand(k_shape, 18)
    ref = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_split_and_merge_heads():
    x = _rand((2, 7, 12), 19)
    ref = jattn.split_heads(jnp.asarray(x), 3)
    out = tattn.split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tattn.merge_heads(out).numpy(), x)


@pytest.mark.parametrize("capture", [None, QKV, OUTPUT])
def test_attention_module(capture):
    p = _randomize(jb.attention_init(jax.random.PRNGKey(0), 32, 2, context_dim=24), 20)
    x = _rand((2, 9, 32), 21)
    ctx = _rand((2, 5, 24), 22)
    ref, ref_taps = jb.attention(p, jnp.asarray(x), jnp.asarray(ctx), heads=2, capture=capture)
    m = _port(lambda: tb.Attention(32, 2, context_dim=24), p)
    out, taps = m(torch.from_numpy(x), torch.from_numpy(ctx), capture=capture)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    assert sorted(taps) == sorted(ref_taps)
    for name in taps:
        np.testing.assert_allclose(taps[name].detach().numpy(), np.asarray(ref_taps[name]),
                                   atol=ATOL)


def test_activations():
    x = _rand((1000,), 23) * 4
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tb.gelu(t).numpy(), np.asarray(jb.gelu(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(tb.silu(t).numpy(), np.asarray(jb.silu(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(tb.quick_gelu(t).numpy(),
                               np.asarray(jb.quick_gelu(jnp.asarray(x))), atol=ATOL)
