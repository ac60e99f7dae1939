"""The PyTorch port's IP-Adapter path against the JAX package's, in float32 on the CPU: the
converters (``convert_clip_vision``, ``convert_ip_adapter``) leaf for leaf, the bridge's
``clip_vision`` / ``ip_proj`` kinds and the UNet's adapter leaves, the CLIP vision tower and its
early-exit penultimate state, the Resampler and the plain projection head, the antialiased
resize, the UNet's IP taps with two adapters and their readout, and ``score_batch(ip_adapter=
True)`` of the SD-1.5 and SDXL scorers on the same weights and injected noise (within 5e-5)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.convert import store as jax_store
from diffsim_tpu.convert import torch_import as JTI
from diffsim_tpu.convert.diffusion_import import convert_sd_unet, convert_vae
from diffsim_tpu.metrics import readout as jreadout
from diffsim_tpu.metrics.diffsim_sd15 import DiffSimSD15 as JaxSD15
from diffsim_tpu.metrics.diffsim_xl import DiffSimXL as JaxXL
from diffsim_tpu.models import clip_text as jclip
from diffsim_tpu.models import clip_vision as jcv
from diffsim_tpu.models import ip_adapter as jipm
from diffsim_tpu.models import unet as junet
from diffsim_tpu.models import vae as jvae
from diffsim_tpu.ops.taps import IP_QKV as J_IP_QKV
from diffsim_tpu.ops.taps import TapSpec as JTapSpec
from diffsim_tpu_torch.convert import bridge, store
from diffsim_tpu_torch.convert import torch_import as TI
from diffsim_tpu_torch.metrics import readout
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
from diffsim_tpu_torch.metrics.diffsim_xl import DiffSimXL
from diffsim_tpu_torch.models import ip_adapter as ipm
from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
from diffsim_tpu_torch.models.clip_vision import CLIPVision, CLIPVisionConfig, out_proj_replay
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import VAEConfig
from diffsim_tpu_torch.ops.blocks import IPProjection
from diffsim_tpu_torch.ops.taps import IP_QKV, TapSpec

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_parity_tiny.npz")
ATOL = 5e-5
TOL = dict(rtol=0, atol=1e-5)
# a second small tower with ViT-H's patch of 14 (3 x 3 patches)
CV14 = dict(hidden=32, layers=3, heads=2, intermediate=64, patch=14, image_size=42,
            projection_dim=16)
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

def _redrawn(tree, seed, std=0.1):
    """A JAX tree with every float leaf redrawn N(0, std) from ``seed`` (numpy); other leaves
    (the plain head's num_tokens) kept."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(np.shape(x)) * std).astype(np.float32)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x for x in leaves])


def _built(factory, tree, kind):
    with torch.device("meta"):
        module = factory()
    return bridge.load(module, tree, kind, "cpu", torch.float32).eval()


def _assert_same_tree(ours, ref):
    a, b = store._flatten(ours), jax_store._flatten(ref)
    assert sorted(a) == sorted(b)
    for key in b:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def _clip_vision_sd(cfg, rng, prefix="vision_model.", projection=True):
    """HF CLIPVisionModelWithProjection names at ``cfg``'s widths."""
    h, p = cfg["hidden"], cfg["patch"]
    tokens = (cfg["image_size"] // p) ** 2 + 1

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"embeddings.class_embedding": r(h), "embeddings.patch_embedding.weight": r(h, 3, p, p),
          "embeddings.position_embedding.weight": r(tokens, h),
          "pre_layrnorm.weight": r(h), "pre_layrnorm.bias": r(h),
          "post_layernorm.weight": r(h), "post_layernorm.bias": r(h)}
    for i in range(cfg["layers"]):
        base = f"encoder.layers.{i}"
        for nm in ("layer_norm1", "layer_norm2"):
            sd[f"{base}.{nm}.weight"], sd[f"{base}.{nm}.bias"] = r(h), r(h)
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{base}.self_attn.{nm}.weight"], sd[f"{base}.self_attn.{nm}.bias"] = r(h, h), r(h)
        sd[f"{base}.mlp.fc1.weight"], sd[f"{base}.mlp.fc1.bias"] = r(cfg["intermediate"], h), \
            r(cfg["intermediate"])
        sd[f"{base}.mlp.fc2.weight"], sd[f"{base}.mlp.fc2.bias"] = r(h, cfg["intermediate"]), r(h)
    sd = {prefix + k: v for k, v in sd.items()}
    if projection:
        sd["visual_projection.weight"] = r(cfg["projection_dim"], h)
    return sd


@pytest.mark.parametrize("prefix,projection", [("vision_model.", True), ("", False)])
def test_convert_clip_vision_matches_jax(prefix, projection):
    sd = _clip_vision_sd(CV14, np.random.default_rng(0), prefix, projection)
    _assert_same_tree(TI.convert_clip_vision(sd, CLIPVisionConfig(**CV14)),
                      JTI.convert_clip_vision(sd, jcv.CLIPVisionConfig(**CV14)))


def _ip_adapter_sd(ucfg, rng, plus: bool):
    """A published ip-adapter(-plus) state dict at the tiny widths, as tests/test_ip_adapter.py
    builds it; the plain head makes 4 tokens."""
    dim, emb, nq, depth, inner = 16, 32, 4, 2, 16

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cross = ucfg.cross_attention_dim
    if plus:
        proj = {"latents": r(1, nq, dim), "proj_in.weight": r(dim, emb), "proj_in.bias": r(dim),
                "proj_out.weight": r(cross, dim), "proj_out.bias": r(cross),
                "norm_out.weight": r(cross), "norm_out.bias": r(cross)}
        for i in range(depth):
            for nm in ("norm1", "norm2"):
                proj[f"layers.{i}.0.{nm}.weight"] = r(dim)
                proj[f"layers.{i}.0.{nm}.bias"] = r(dim)
            proj[f"layers.{i}.0.to_q.weight"] = r(inner, dim)
            proj[f"layers.{i}.0.to_kv.weight"] = r(2 * inner, dim)
            proj[f"layers.{i}.0.to_out.weight"] = r(dim, inner)
            proj[f"layers.{i}.1.0.weight"], proj[f"layers.{i}.1.0.bias"] = r(dim), r(dim)
            proj[f"layers.{i}.1.1.weight"] = r(dim * 2, dim)
            proj[f"layers.{i}.1.3.weight"] = r(dim, dim * 2)
    else:
        proj = {"proj.weight": r(4 * cross, emb), "proj.bias": r(4 * cross),
                "norm.weight": r(cross), "norm.bias": r(cross)}
    sd = {f"image_proj.{k}": v for k, v in proj.items()}
    n = len(ucfg.block_out_channels)
    for s_i, (kind, bi, _, _) in enumerate(ipm.attn2_site_order(ucfg)):
        di = (n - 1 - bi) if kind == "up" else bi
        hidden = ucfg.block_out_channels[di if kind != "mid" else -1]
        for nm in ("to_k_ip", "to_v_ip"):
            sd[f"ip_adapter.{2 * s_i + 1}.{nm}.weight"] = r(hidden, cross)
    return sd


@pytest.mark.parametrize("plus", [True, False])
@pytest.mark.parametrize("split", [False, True])
def test_convert_ip_adapter_matches_jax(plus, split):
    """The flat safetensors layout and the pre-split {'image_proj', 'ip_adapter'} dict."""
    sd = _ip_adapter_sd(UNetConfig.tiny(), np.random.default_rng(1), plus)
    if split:
        sd = {part: {k[len(part) + 1:]: v for k, v in sd.items() if k.startswith(part + ".")}
              for part in ("image_proj", "ip_adapter")}
    ours = TI.convert_ip_adapter(sd, UNetConfig.tiny())
    ref = JTI.convert_ip_adapter(sd, junet.UNetConfig.tiny())
    assert ours["plus"] is ref["plus"] is plus
    _assert_same_tree({k: v for k, v in ours.items() if k != "plus"},
                      {k: v for k, v in ref.items() if k != "plus"})


@pytest.mark.parametrize("cfg", ["tiny", "sd15", "sdxl"])
def test_attn2_site_order_matches_jax(cfg):
    ours = ipm.attn2_site_order(getattr(UNetConfig, cfg)())
    assert ours == jipm.attn2_site_order(getattr(junet.UNetConfig, cfg)())
    assert len(ours) == {"tiny": 4, "sd15": 16, "sdxl": 70}[cfg]


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

RCFG = dataclasses.replace(jipm.ResamplerConfig.tiny(), output_dim=32)


def _jax_ip_tree(case):
    key = jax.random.PRNGKey(3)
    if case == "clip_vision":
        return jax.device_get(jcv.init(key, jcv.CLIPVisionConfig(**CV14), jnp.float32))
    if case == "resampler":
        return jax.device_get(jipm.resampler_init(key, RCFG))
    if case == "image_projection":
        return jax.device_get(jipm.image_projection_init(key, 16, 32, 4))
    unet = jax.device_get(junet.init(key, junet.UNetConfig.tiny(), jnp.float32))
    ip = jax.device_get(jipm.random_ip_weights(key, junet.UNetConfig.tiny(), num_adapters=2))
    return jipm.insert_ip_into_unet(unet, junet.UNetConfig.tiny(), ip)


def _unet_with_ip(num_adapters=2):
    unet = UNet(UNetConfig.tiny())
    ipm.insert_ip_into_unet(unet, [
        [IPProjection(a.to_k.in_features, a.to_q.out_features) for _ in range(num_adapters)]
        for a in ipm.attn2_modules(unet)])
    return unet


_IP_FACTORIES = {
    "clip_vision": (lambda: CLIPVision(CLIPVisionConfig(**CV14)), "clip_vision"),
    "resampler": (lambda: ipm.Resampler(ipm.ResamplerConfig(**dataclasses.asdict(RCFG))),
                  "ip_proj"),
    "image_projection": (lambda: ipm.ImageProjection(16, 32, 4), "ip_proj"),
    "unet_ip": (_unet_with_ip, "unet"),
}


@pytest.mark.parametrize("case", sorted(_IP_FACTORIES))
def test_bridge_round_trips_the_ip_trees_strictly(case):
    """The CLIP vision tower (tables and the dense patch embedding), both projection heads (the
    plain head's num_tokens carried as configuration) and a UNet with two adapters per attn2."""
    tree = _jax_ip_tree(case)
    factory, kind = _IP_FACTORIES[case]
    state = _built(factory, tree, kind).state_dict()
    flat = jax_store._flatten(tree)
    assert len(state) == len(flat) - (case == "image_projection")
    back = store._flatten(bridge.to_jax_tree(state, kind))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr)


def test_bridge_refuses_a_num_tokens_that_does_not_fit():
    tree = _jax_ip_tree("image_projection")
    tree["num_tokens"] = 3
    with pytest.raises(ValueError, match="num_tokens"):
        bridge.from_jax_tree(tree, "ip_proj")


# ---------------------------------------------------------------------------
# the encoder, the heads, the resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", ["tiny", "patch14"])
def test_clip_vision_matches_jax(cfg):
    jcfg = jcv.CLIPVisionConfig.tiny() if cfg == "tiny" else jcv.CLIPVisionConfig(**CV14)
    tcfg = CLIPVisionConfig(**dataclasses.asdict(jcfg))
    tree = _redrawn(jcv.init(jax.random.PRNGKey(0), jcfg), 4)
    x = np.random.default_rng(5).standard_normal((3, jcfg.image_size, jcfg.image_size, 3))
    x = x.astype(np.float32)
    ref = jax.jit(lambda p, x_: jcv.apply(p, x_, jcfg, output_hidden_states=True))(
        tree, jnp.asarray(x))
    model = _built(lambda: CLIPVision(tcfg), tree, "clip_vision")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = model(xt, output_hidden_states=True)
        pen = model.penultimate(xt)
    assert len(out["hidden_states"]) == len(ref["hidden_states"]) == tcfg.layers + 1
    for ours, want in zip(out["hidden_states"], ref["hidden_states"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), **TOL)
    for key in ("last_hidden_state", "pooled", "image_embeds"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL)
    np.testing.assert_array_equal(pen.numpy(), out["hidden_states"][-2].numpy())


def test_clip_vision_taps_wait_for_the_clip_metrics():
    """The CLIP metrics' taps, which this encoder once left to them, now run on it
    (tests/test_torch_port_baselines.py holds them to JAX)."""
    model = CLIPVision(CLIPVisionConfig.tiny())
    model = model.to_empty(device="cpu")
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.zeros(1, 3, 32, 32)
    with torch.no_grad():
        taps = model.tap(x, 0)
        assert sorted(taps) == ["k", "q", "v"] and taps["q"].shape == (1, 2, 17, 16)
        out = out_proj_replay(model, taps["q"], 0)
    assert out.shape == (1, 17, 32) and torch.isfinite(out).all()


def test_resampler_and_image_projection_match_jax():
    rng = np.random.default_rng(6)
    tree = _redrawn(jipm.resampler_init(jax.random.PRNGKey(0), RCFG), 7)
    x = rng.standard_normal((2, 17, RCFG.embedding_dim)).astype(np.float32)
    model = _built(_IP_FACTORIES["resampler"][0], tree, "ip_proj")
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(lambda p, x_: jipm.resampler_apply(p, x_, RCFG))(tree,
                                                                              jnp.asarray(x)))
    assert out.shape == (2, RCFG.num_queries, RCFG.output_dim)
    np.testing.assert_allclose(out, ref, **TOL)

    tree = _redrawn(jipm.image_projection_init(jax.random.PRNGKey(0), 16, 32, 4), 8)
    e = rng.standard_normal((3, 16)).astype(np.float32)
    model = _built(_IP_FACTORIES["image_projection"][0], tree, "ip_proj")
    with torch.no_grad():
        out = model(torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(out, np.asarray(jipm.image_projection_apply(tree, jnp.asarray(e))),
                               **TOL)


@pytest.mark.parametrize("src,dst", [(512, 224), (1024, 224), (256, 224), (64, 32), (33, 7),
                                     (32, 32)])
def test_resize_matches_jax_image_resize(src, dst):
    """The sizes the scorers resize by (the IP encoder's input, the masks' latent grids, the
    tiny encoder's identity; they never grow): shrinking antialiases as jax.image.resize does
    (PyTorch's default bilinear differs by up to 3.27 at 512 -> 224)."""
    x = np.random.default_rng(src + dst).uniform(-1, 1, (2, src, src, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), "bilinear"))
    out = readout.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the UNet's IP taps, two adapters
# ---------------------------------------------------------------------------


def test_unet_ip_taps_and_readout_match_jax_with_two_adapters():
    """Two adapters in every attn2: the forward (each adapter's attention added at its scale),
    the IP_QKV taps at an up-block attn2 (per-adapter K/V lists, the forward stopped there)
    and their readout, averaged over the adapters for cosine and summed for mse (quirk Q4)."""
    jcfg = junet.UNetConfig.tiny()
    tree = _redrawn(_jax_ip_tree("unet_ip"), 9)
    model = _built(_unet_with_ip, tree, "unet")
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((4, 7, 32)).astype(np.float32)
    ip = [rng.standard_normal((4, 3, 32)).astype(np.float32) for _ in range(2)]
    scale = [0.5, 0.25]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ipt = [torch.from_numpy(e) for e in ip]
    with torch.no_grad():
        eps, _ = model(xt, 600.0, torch.from_numpy(ctx), ip_embeds=ipt, ip_scale=scale)
        _, taps = model(xt, 600.0, torch.from_numpy(ctx), tap=TapSpec("up", (1, -1, -1), "attn2",
                                                                      IP_QKV),
                        ip_embeds=ipt, ip_scale=scale)
    def jax_unet(tap):
        return jax.jit(lambda p, x_, c, e: junet.apply(p, x_, jnp.float32(600.0), c, jcfg,
                                                       tap=tap, ip_embeds=e, ip_scale=scale))

    args = (tree, jnp.asarray(x), jnp.asarray(ctx), [jnp.asarray(e) for e in ip])
    ref_eps, _ = jax_unet(None)(*args)
    np.testing.assert_allclose(eps.permute(0, 2, 3, 1).numpy(), np.asarray(ref_eps), **TOL)
    _, ref = jax_unet(JTapSpec("up", (1, -1, -1), "attn2", J_IP_QKV))(*args)
    assert len(taps["ip_k"]) == len(taps["ip_v"]) == 2
    np.testing.assert_allclose(taps["q"].numpy(), np.asarray(ref["q"]), **TOL)
    for name in ("ip_k", "ip_v"):
        for ours, want in zip(taps[name], ref[name]):
            np.testing.assert_allclose(ours.numpy(), np.asarray(want), **TOL)

    def pairs(t):  # rows [a_u, a_c, b_u, b_c] -> (P=1, 4, ...)
        return t[None]

    for similarity in ("cosine", "mse"):
        out = readout.cross_attention_score_ip(
            pairs(taps["q"])[:, :2], [pairs(k)[:, :2] for k in taps["ip_k"]],
            [pairs(v)[:, :2] for v in taps["ip_v"]], pairs(taps["q"])[:, 2:],
            [pairs(k)[:, 2:] for k in taps["ip_k"]], [pairs(v)[:, 2:] for v in taps["ip_v"]],
            similarity)
        want = jreadout.cross_attention_score_ip(
            pairs(ref["q"])[:, :2], [pairs(k)[:, :2] for k in ref["ip_k"]],
            [pairs(v)[:, :2] for v in ref["ip_v"]], pairs(ref["q"])[:, 2:],
            [pairs(k)[:, 2:] for k in ref["ip_k"]], [pairs(v)[:, 2:] for v in ref["ip_v"]],
            similarity)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        one = readout.cross_attention_score(
            pairs(taps["q"])[:, :2], pairs(taps["ip_k"][0])[:, :2],
            pairs(taps["ip_v"][0])[:, :2], pairs(taps["q"])[:, 2:],
            pairs(taps["ip_k"][0])[:, 2:], pairs(taps["ip_v"][0])[:, 2:], similarity)
        assert not torch.allclose(out, one)  # the second adapter counts


# ---------------------------------------------------------------------------
# the scorers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sd15_params():
    d = np.load(FIXTURE)
    sds = {"unet": {}, "vae": {}}
    for key in d.files:
        if key.startswith("sd::"):
            _, which, name = key.split("::", 2)
            sds[which][name] = d[key]
    return {
        "unet": jax.device_get(convert_sd_unet(sds["unet"], junet.UNetConfig.tiny(), strict=True)),
        "vae": jax.device_get(convert_vae(sds["vae"], jvae.VAEConfig.tiny(), strict=True)[0]),
        "text": _redrawn(jclip.init(jax.random.PRNGKey(0), jclip.CLIPTextConfig.tiny()), 0),
    }


def _ip_trees(unet_cfg, seed):
    """A tiny IP-Adapter-plus of the UNet's cross dim (the converted layout) and a tiny CLIP
    vision tree, every leaf redrawn from ``seed``."""
    rcfg = dataclasses.replace(jipm.ResamplerConfig.tiny(), output_dim=unet_cfg.cross_attention_dim)
    key = jax.random.PRNGKey(seed)
    converted = {
        "image_proj": _redrawn(jipm.resampler_init(key, rcfg), seed),
        "ip_weights": _redrawn(jipm.random_ip_weights(key, unet_cfg), seed + 1),
        "plus": True,
    }
    encoder = _redrawn(jcv.init(key, jcv.CLIPVisionConfig.tiny()), seed + 2)
    return converted, encoder, rcfg


def _enable(scorer, converted, encoder, rcfg, torch_side: bool):
    if torch_side:
        scorer.enable_ip_adapter(converted, encoder_params=encoder,
                                 encoder_cfg=CLIPVisionConfig.tiny(),
                                 resampler_cfg=ipm.ResamplerConfig(**dataclasses.asdict(rcfg)))
    else:
        scorer.enable_ip_adapter(converted, encoder_params=encoder,
                                 encoder_cfg=jcv.CLIPVisionConfig.tiny(), resampler_cfg=rcfg)
    return scorer


def _pairs(seed, n, size, latent):
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8) for _ in range(2))
    noise = tuple(rng.standard_normal((2, latent, latent, 4)).astype(np.float32)
                  for _ in range(2))
    return a, b, noise


@pytest.fixture(scope="module")
def sd15_ip(sd15_params):
    trees = _ip_trees(junet.UNetConfig.tiny(), 20)
    scorers = {}
    for parity in (True, False):
        port = DiffSimSD15(sd15_params, unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny(),
                           text_cfg=CLIPTextConfig.tiny(), img_size=32, dtype=torch.float32,
                           device="cpu", cfg_parity=parity)
        ref = JaxSD15(sd15_params, unet_cfg=junet.UNetConfig.tiny(), vae_cfg=jvae.VAEConfig.tiny(),
                      text_cfg=jclip.CLIPTextConfig.tiny(), img_size=32, dtype=jnp.float32,
                      cfg_parity=parity)
        scorers[parity] = (_enable(port, *trees, True), _enable(ref, *trees, False))
    return scorers


@pytest.mark.parametrize("cfg_parity", [True, False])
@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_sd15_ip_score_batch_matches_jax(sd15_ip, cfg_parity, similarity):
    """The ipref preset's tap (--target_layer 5 collapses to up block 1), both CFG layouts of
    the IP tokens ([uncond, cond] per image, or cond alone)."""
    port, ref = sd15_ip[cfg_parity]
    a, b, noise = _pairs(21, 3, 32, 16)
    kw = dict(prompt=["a photo", "x", "a photo"], target_block="up_blocks", target_layer=[5],
              target_step=750, similarity=similarity, ip_adapter=True, noise_override=noise)
    want = ref.score_batch(a, b, **kw)
    out = port.score_batch(a, b, **kw)
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
    assert not np.allclose(out, port.score_batch(a, b, **{**kw, "ip_adapter": False}))


def test_sd15_ip_uncond_tokens_come_from_zeros_in_clip_space(sd15_ip):
    port, ref = sd15_ip[True]
    np.testing.assert_allclose(port._ip_uncond.numpy(), np.asarray(ref._ip_uncond), **TOL)
    assert port.ip_encoder is not None and port.ip_proj is not None  # counted by the guard


@pytest.fixture(scope="module")
def xl_params():
    k = jax.random.split(jax.random.PRNGKey(1), 4)
    return {
        "unet": _redrawn(junet.init(k[0], junet.UNetConfig.tiny_xl(64)), 30, 0.05),
        "vae": _redrawn(jvae.encoder_init(k[1], jvae.VAEConfig.tiny()), 31, 0.05),
        "text": _redrawn(jclip.init(k[2], jclip.CLIPTextConfig.tiny()), 32),
        "text2": _redrawn(jclip.init(k[3], jclip.CLIPTextConfig(**TEXT2)), 33),
    }


@pytest.fixture(scope="module")
def xl_ip(xl_params):
    trees = _ip_trees(junet.UNetConfig.tiny_xl(64), 40)
    port = _enable(DiffSimXL(xl_params, unet_cfg=UNetConfig.tiny_xl(64), vae_cfg=VAEConfig.tiny(),
                             text_cfg=CLIPTextConfig.tiny(), text2_cfg=CLIPTextConfig(**TEXT2),
                             img_size=32, dtype=torch.float32, device="cpu"), *trees, True)
    ref = _enable(JaxXL(xl_params, unet_cfg=junet.UNetConfig.tiny_xl(64),
                        vae_cfg=jvae.VAEConfig.tiny(), text_cfg=jclip.CLIPTextConfig.tiny(),
                        text2_cfg=jclip.CLIPTextConfig(**TEXT2), img_size=32, dtype=jnp.float32),
                  *trees, False)
    return port, ref


@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_sdxl_ip_score_batch_matches_jax(xl_ip, similarity):
    port, ref = xl_ip
    a, b, noise = _pairs(41, 2, 32, 16)
    kw = dict(prompt="a photo", target_block="up_blocks", target_layer=(0, 1, 1),
              target_step=900, similarity=similarity, ip_adapter=True, noise_override=noise)
    np.testing.assert_allclose(port.score_batch(a, b, **kw), ref.score_batch(a, b, **kw),
                               rtol=0, atol=ATOL)


def test_ip_adapter_without_weights_attaches_random_ones(sd15_params, monkeypatch, capsys):
    """``score_batch(ip_adapter=True)`` with nothing attached says so and draws random weights:
    the default encoder (ViT-H/14, made tiny here) and a Resampler of the UNet's cross dim, as
    the JAX scorer sizes it; ``plus=False`` attaches the plain head on the image embedding."""
    from diffsim_tpu_torch.metrics import scorer_base

    monkeypatch.setattr(scorer_base.CLIPVisionConfig, "h14", staticmethod(CLIPVisionConfig.tiny))
    port = DiffSimSD15(sd15_params, unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny(),
                       text_cfg=CLIPTextConfig.tiny(), img_size=32, dtype=torch.float32,
                       device="cpu")
    monkeypatch.setattr(port, "_default_resampler_cfg", ipm.ResamplerConfig.tiny)
    a, b, _ = _pairs(50, 2, 32, 16)
    s = port.score_batch(a, b, ip_adapter=True)
    assert "RANDOM" in capsys.readouterr().out
    assert s.shape == (2,) and np.isfinite(s).all()
    assert port._ip["plus"] and port._ip["resampler_cfg"].output_dim == 32
    port.enable_ip_adapter(plus=False)
    assert isinstance(port.ip_proj, ipm.ImageProjection) and port._ip_uncond.shape == (1, 4, 32)
    assert np.isfinite(port.score_batch(a, b, ip_adapter=True)).all()


@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_flat_readouts_reduce_in_float64(similarity):
    """The readouts' flat reductions at an IP tap of 4096 tokens (524288 elements a pair) equal
    the float64 value of the float32 inputs: a float32 sum there is off by up to ~1e-5 of the
    cosine, by an amount that depends on the device's summation order."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 2, 2, 4096, 32)).astype(np.float32)
    y = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    out = readout.feature_score(xt, yt, similarity)
    x64, y64 = x.reshape(2, -1).astype(np.float64), y.reshape(2, -1).astype(np.float64)
    if similarity == "cosine":
        want = (x64 * y64).sum(-1) / (np.linalg.norm(x64, axis=-1) * np.linalg.norm(y64, axis=-1))
    else:
        want = ((x64 - y64) ** 2).mean(-1)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want.astype(np.float32), rtol=1e-7, atol=0)
