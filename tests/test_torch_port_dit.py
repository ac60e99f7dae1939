"""The PyTorch port's DiT scorer (diffsim_tpu_torch/metrics/diffsim_dit.py) and its modules
against the JAX package's, in float32 on the CPU: the DiT schedule (the respaced model timestep),
the DiT forward and its QKV taps, the committed torch fixture's DiT grid through the port's own
converter, the scorer against the JAX ``DiffSimDiT`` with injected noise (``noise_override``) at
the fixture's tiny config and at a config whose tap has DiT-XL/2's head dim 72 and 1024 tokens,
where the port takes K1's and K3's plain versions, and the triplet and cached paths held to the
port's own ``score_batch``. Scores agree within 5e-5."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.convert.diffusion_import import convert_dit as jax_convert_dit
from diffsim_tpu.convert.diffusion_import import convert_vae as jax_convert_vae
from diffsim_tpu.core import schedulers as jsched
from diffsim_tpu.metrics.diffsim_dit import DiffSimDiT as JaxDiffSimDiT
from diffsim_tpu.models import dit as jdit
from diffsim_tpu.models import vae as jvae
from diffsim_tpu.ops.taps import TapSpec as JTapSpec
from diffsim_tpu_torch.convert.diffusion_import import convert_dit, convert_vae
from diffsim_tpu_torch.core import schedulers
from diffsim_tpu_torch.metrics.diffsim_dit import DiffSimDiT
from diffsim_tpu_torch.metrics.scorer_base import build_module
from diffsim_tpu_torch.models import dit
from diffsim_tpu_torch.models.vae import VAEConfig
from diffsim_tpu_torch.ops.kernels import attention as k1_module
from diffsim_tpu_torch.ops.kernels import readout as k3_module
from diffsim_tpu_torch.ops.taps import TapSpec

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_parity_xl_dit.npz")
ATOL = 5e-5
FIX_DIT = dict(input_size=16, num_classes=10)  # the fixture's DiT, scored at 32 px
# a tap of DiT-XL/2's head dim (144 / 2 = 72) and token count (32 x 32) at 128 px with the tiny VAE
HD72 = dict(input_size=64, patch_size=2, hidden=144, depth=2, heads=2, num_classes=10)


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


# ---------------------------------------------------------------------------
# the DiT schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,sections", [(1000, [600]), (1000, [250]), (1000, [10, 15, 20]),
                                        (1000, [1000]), (100, [33, 7]), (17, [5])])
def test_space_timesteps_matches_jax(n, sections):
    assert schedulers.space_timesteps(n, sections) == jsched.space_timesteps(n, sections)


@pytest.mark.parametrize("step", [501, 550, 600, 667, 700, 800, 900, 999, 1000])
def test_dit_noise_spec_matches_jax(step):
    ours, ref = schedulers.dit_noise_spec(step), jsched.dit_noise_spec(step)
    assert (ours.model_t, ours.a, ours.b) == (ref.model_t, ref.a, ref.b)
    for backbone in ("dit", "diffsim_dit", "sd15", "sdxl"):
        assert (dataclasses.astuple(schedulers.noise_spec(backbone, step))
                == dataclasses.astuple(jsched.noise_spec(backbone, step)))


@pytest.mark.parametrize("step", [0, 100, 499, 500])
def test_dit_noise_spec_raises_at_or_below_500(step):
    with pytest.raises(ValueError, match="target_step > 500"):
        schedulers.dit_noise_spec(step)
    with pytest.raises(ValueError):
        jsched.dit_noise_spec(step)


def test_linear_betas_match_jax():
    np.testing.assert_array_equal(schedulers.betas_linear(), jsched.betas_linear())
    np.testing.assert_array_equal(schedulers.alphas_cumprod("linear"),
                                  jsched.alphas_cumprod("linear"))
    with pytest.raises(ValueError):
        schedulers.noise_spec("unet", 600)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_tree():
    return _redrawn(jdit.init(jax.random.PRNGKey(1), jdit.DiTConfig.tiny(), jnp.float32), 1)


@pytest.mark.parametrize("layer", [0, 1, -1])
def test_dit_forward_and_taps_match_jax(tiny_tree, layer):
    """The output (no tap) within 1e-5, and the QKV taps of the forward that returns at the tap."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    t = np.array([5.0, 400.0, 999.0], np.float32)
    y = np.array([1, 10, 3])
    ref_out, ref = jdit.apply(tiny_tree, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t),
                              jnp.asarray(y), jdit.DiTConfig.tiny(),
                              tap=JTapSpec("blocks", (layer,)))
    model = build_module(lambda: dit.DiT(dit.DiTConfig.tiny()), tiny_tree, "dit",
                         torch.device("cpu"), torch.float32, None)
    tap = TapSpec("blocks", (layer,))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    out, none = model(*args)
    assert none == {} and out.shape == x.shape
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref_out),
                               rtol=0, atol=1e-5)
    stopped, taps = model(*args, tap=tap)
    assert stopped is None
    for name in ("q", "k", "v"):
        assert taps[name].shape == (3, 2, 16, 16) and taps[name].is_contiguous()
        np.testing.assert_allclose(taps[name].numpy(), np.asarray(ref[name]), rtol=0, atol=1e-5)


def test_patchify_round_trips_in_the_jax_feature_order():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    ours = dit.patchify(torch.from_numpy(x), 2)
    ref = jdit.patchify(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(dit.unpatchify(ours, 2, 4).numpy(), x)


def test_pos_embed_and_zoo_match_jax():
    np.testing.assert_array_equal(dit.pos_embed_2d(1152, 32), jdit.pos_embed_2d(1152, 32))
    assert sorted(dit.MODELS) == sorted(jdit.MODELS)
    # the port's config holds every field of the JAX config, the label dropout included
    fields = [f.name for f in dataclasses.fields(dit.DiTConfig)]
    for make, jmake in [(dit.MODELS[n], jdit.MODELS[n]) for n in dit.MODELS] + [
            (dit.DiTConfig.xl2, jdit.DiTConfig.xl2), (dit.DiTConfig.tiny, jdit.DiTConfig.tiny)]:
        ours, ref = make(input_size=64), jmake(input_size=64)
        assert {f: getattr(ours, f) for f in fields} == {f: getattr(ref, f) for f in fields}
        assert set(vars(ref)) == set(fields)


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------


def _split_state_dict(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def fix():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files if k.startswith(("dit", "vae::"))}


@pytest.fixture(scope="module")
def fix_params(fix):
    """The fixture's DiT and VAE state dicts through the PORT's converter."""
    return {"dit": convert_dit(_split_state_dict(fix, "dit::model::"),
                               dit.DiTConfig.tiny(**FIX_DIT)),
            "vae": convert_vae(_split_state_dict(fix, "vae::"), VAEConfig.tiny())[0]}


@pytest.fixture(scope="module")
def fix_scorer(fix_params):
    return DiffSimDiT(fix_params, dit_cfg=dit.DiTConfig.tiny(**FIX_DIT), vae_cfg=VAEConfig.tiny(),
                      img_size=32, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def jax_fix_scorer(fix):
    dcfg = jdit.DiTConfig.tiny(**FIX_DIT)
    params = {"dit": jax_convert_dit(_split_state_dict(fix, "dit::model::"), dcfg),
              "vae": jax_convert_vae(_split_state_dict(fix, "vae::"), jvae.VAEConfig.tiny())[0]}
    return JaxDiffSimDiT(params, dit_cfg=dcfg, vae_cfg=jvae.VAEConfig.tiny(), img_size=32,
                         dtype=jnp.float32)


def _fixture_inputs(fix):
    pix = fix["dit_pair_pixels"].transpose(0, 1, 3, 4, 2).astype(np.float32)  # (64, 2, H, W, 3)
    noise = (fix["dit_eps_vae"][:, 0].transpose(0, 2, 3, 1),
             fix["dit_eps_noise"][:, 0].transpose(0, 2, 3, 1))
    return pix, noise


DIT_GRID = [(layer, step, sim) for layer in (0, 1) for step in (600, 800)
            for sim in ("cosine", "mse")]


@pytest.mark.parametrize("layer,step,sim", DIT_GRID)
def test_score_grid_matches_the_torch_fixture_and_jax(fix, fix_scorer, jax_fix_scorer, layer,
                                                      step, sim):
    """The 64-pair DiT grid of tests/fixtures/torch_parity_xl_dit.npz, held as the JAX package
    holds it (tests/test_torch_parity_xl_dit.py), and the JAX scorer on the same weights."""
    pix, noise = _fixture_inputs(fix)
    kw = dict(target_layer=layer, target_step=step, similarity=sim, noise_override=noise)
    scores = fix_scorer.score_batch(pix[:, 0], pix[:, 1], **kw)
    assert scores.shape == (64,) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, fix[f"dit_grid::{layer}::{step}::{sim}"], rtol=5e-4,
                               atol=ATOL)
    ref = jax_fix_scorer.score_batch(pix[:16, 0], pix[:16, 1], **kw)
    np.testing.assert_allclose(scores[:16], ref, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def hd72_scorers():
    """The port's and the JAX scorer on one redrawn tree of the head-dim-72 config."""
    params = {"dit": _redrawn(jdit.init(jax.random.PRNGKey(2), jdit.DiTConfig(**HD72),
                                        jnp.float32), 2),
              "vae": _redrawn(jvae.encoder_init(jax.random.PRNGKey(3), jvae.VAEConfig.tiny(),
                                                jnp.float32), 3)}
    port = DiffSimDiT(params, dit_cfg=dit.DiTConfig(**HD72), vae_cfg=VAEConfig.tiny(),
                      img_size=128, dtype=torch.float32, device="cpu")
    ref = JaxDiffSimDiT(params, dit_cfg=jdit.DiTConfig(**HD72), vae_cfg=jvae.VAEConfig.tiny(),
                        img_size=128, dtype=jnp.float32)
    return port, ref


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts of the calls of K1's and K3's plain versions, which a CPU tensor takes where the
    card would launch the kernels."""
    calls = {"fused_self_attention": [], "cross_self_partials": []}
    for module, name, key in ((k1_module, "fused_self_attention_plain", "fused_self_attention"),
                              (k3_module, "cross_self_partials_plain", "cross_self_partials")):
        plain = getattr(module, name)

        def counted(q, *args, _plain=plain, _key=key, **kw):
            calls[_key].append(tuple(q.shape))
            return _plain(q, *args, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_head_dim_72_route_takes_the_plain_kernels_and_matches_jax(hd72_scorers, plain_calls,
                                                                   layer, similarity):
    """At 1024 tokens and head dim 72 the DiT's attention routes to K1 and the readout to K3,
    as on the card; on the CPU both take their plain versions. One pair: one K1 call for the
    tiny VAE's mid attention (4096 tokens at D 64), one per block before the tap, and K3 once
    per direction."""
    rng = np.random.default_rng(layer)
    a, b = (rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32) for _ in range(2))
    noise = tuple(rng.standard_normal((2, 64, 64, 4)).astype(np.float32) for _ in range(2))
    kw = dict(target_layer=layer, target_step=600, similarity=similarity, noise_override=noise)
    port, jax_scorer = hd72_scorers
    out = port.score_batch(a, b, **kw)
    assert plain_calls["fused_self_attention"] == [(2, 1, 4096, 64)] + [(4, 2, 1024, 72)] * layer
    assert plain_calls["cross_self_partials"] == [(4, 1024, 72)] * 2
    np.testing.assert_allclose(out, jax_scorer.score_batch(a, b, **kw), rtol=0, atol=ATOL)


@pytest.mark.parametrize("vae_mode", [False, True])
def test_score_batch_matches_jax_on_uint8_pixels_and_vae_mode(fix_params, vae_mode):
    """uint8 pixels, a block index given as a list, and the posterior mean (``vae_mode``)."""
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8) for _ in range(2))
    noise = tuple(rng.standard_normal((2, 16, 16, 4)).astype(np.float32) for _ in range(2))
    kw = dict(target_layer=[1], target_step=700, noise_override=noise)
    out = DiffSimDiT(fix_params, dit_cfg=dit.DiTConfig.tiny(**FIX_DIT), vae_cfg=VAEConfig.tiny(),
                     img_size=32, dtype=torch.float32, device="cpu",
                     vae_mode=vae_mode).score_batch(a, b, **kw)
    ref = JaxDiffSimDiT(jax.tree_util.tree_map(np.asarray, fix_params),
                        dit_cfg=jdit.DiTConfig.tiny(**FIX_DIT), vae_cfg=jvae.VAEConfig.tiny(),
                        img_size=32, dtype=jnp.float32, vae_mode=vae_mode).score_batch(a, b, **kw)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("chunk", [None, 2])
def test_triplet_batch_equals_two_score_batches(fix_scorer, chunk):
    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8) for _ in range(3))
    kw = dict(target_layer=1, target_step=600, seed=2334)
    s_ab, s_ac = fix_scorer.score_triplet_batch(a, b, c, chunk=chunk, **kw)
    np.testing.assert_allclose(s_ab, fix_scorer.score_batch(a, b, **kw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s_ac, fix_scorer.score_batch(a, c, **kw), rtol=0, atol=1e-6)


def test_triplet_paths_through_the_moment_cache(fix_params, tmp_path):
    """Cached scores equal the fresh triplet path's, and an all-hit rescore is bit for bit."""
    from PIL import Image

    rng = np.random.default_rng(6)
    roles, pix = [], []
    for r in "abc":
        arr = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
        paths = [str(tmp_path / f"{r}{i}.png") for i in range(3)]
        for path, img in zip(paths, arr):
            Image.fromarray(img).save(path)
        roles.append(paths)
        pix.append(arr)
    roles[2][0], pix[2][0] = roles[1][1], pix[1][1]  # an image in two roles: one miss
    scorer = DiffSimDiT(fix_params, dit_cfg=dit.DiTConfig.tiny(**FIX_DIT),
                        vae_cfg=VAEConfig.tiny(), img_size=32, dtype=torch.float32, device="cpu")
    kw = dict(target_layer=0, target_step=800, similarity="cosine", seed=7)
    fresh = scorer.score_triplet_batch(*pix, **kw)
    cached = scorer.score_triplet_paths(*roles, **kw)
    stats = dict(scorer._moment_cache.stats)
    assert stats["misses"] == 8 and stats["hits"] == 1
    again = scorer.score_triplet_paths(*roles, **kw)
    assert scorer._moment_cache.stats["misses"] == 8
    for f, c, g in zip(fresh, cached, again):
        np.testing.assert_allclose(c, f, rtol=0, atol=2e-6)
        np.testing.assert_array_equal(g, c)
    # the default tap is block 13, as in the JAX scorer: 13 % depth 2 = block 1
    np.testing.assert_array_equal(
        scorer.score_triplet_paths(*roles, **{**kw, "target_layer": 13})[0],
        scorer.score_triplet_paths(*roles, **{k: v for k, v in kw.items()
                                               if k != "target_layer"})[0])


def test_diffsim_score_on_image_paths(fix_scorer, tmp_path):
    from PIL import Image

    from diffsim_tpu_torch.core.image import load_and_process

    rng = np.random.default_rng(8)
    paths = []
    for i in range(2):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    out = fix_scorer.diffsim_score(paths[0], paths[1], target_layer=(1,), seed=11)
    want = fix_scorer.score_batch(load_and_process(paths[0], 32),
                                  load_and_process(paths[1], 32), target_layer=1, seed=11)
    assert isinstance(out, float) and out == float(want[0])


def test_random_init_keeps_the_sin_cos_table_and_refuses_partial_trees(fix_params):
    scorer = DiffSimDiT(dit_cfg=dit.DiTConfig.tiny(**FIX_DIT), vae_cfg=VAEConfig.tiny(),
                        img_size=32, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(scorer.dit.pos_embed.numpy(), dit.pos_embed_2d(32, 8))
    with pytest.raises(ValueError, match="exactly"):
        DiffSimDiT({"dit": fix_params["dit"]}, dit_cfg=dit.DiTConfig.tiny(**FIX_DIT),
                   vae_cfg=VAEConfig.tiny(), img_size=32, device="cpu")
