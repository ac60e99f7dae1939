"""The device-memory guard of the port's pair paths (``runtime/hbm_guard.check_pairs``), on the
CPU with the tiny SD-1.5, SDXL and DiT configs.

``score_batch`` of the three DiffSim scorers has no chunk loop: as in the JAX scorers
(``tests/test_hbm_guard.py::test_pair_path_refused_over_budget``), a batch of P pairs whose
estimate exceeds the budget is refused on the host before any module runs, and a batch within
it scores. Each budget here is placed at the scorer's static bytes plus 4.5 pairs, so 4 pairs fit
and 8 do not."""

import types

import numpy as np
import pytest
import torch

from diffsim_tpu.runtime import hbm_guard as jax_guard
from diffsim_tpu_torch.metrics.diffsim_dit import DiffSimDiT
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
from diffsim_tpu_torch.metrics.diffsim_xl import DiffSimXL
from diffsim_tpu_torch.metrics.registry import _attach_ip, _tiny_configs
from diffsim_tpu_torch.models.ip_adapter import attn2_modules
from diffsim_tpu_torch.runtime import hbm_guard
from diffsim_tpu_torch.runtime.hbm_guard import HbmBudgetError

CLASSES = {"diffsim": DiffSimSD15, "diffsim_xl": DiffSimXL, "dit": DiffSimDiT}
ARGS = {"diffsim": dict(prompt="p", target_step=600, target_layer=(0,)),
        "diffsim_xl": dict(prompt="p", target_step=900, target_layer=(0, 1, 1)),
        "dit": dict(target_step=600, target_layer=0)}
DTYPES = [torch.bfloat16, torch.float32]
# each backbone at the size its scorers run at, for the estimate alone
PUBLISHED = [(DiffSimSD15, 512), (DiffSimXL, 1024), (DiffSimDiT, 512)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scorer():
    """``scorer(name, dtype, ip=False)``: one tiny 32 px scorer of each backbone, dtype and
    IP-Adapter attachment, built once for the module."""
    built = {}

    def get(name, dtype=torch.float32, ip=False):
        key = (name, dtype, ip)
        if key not in built:
            s = CLASSES[name](img_size=32, device="cpu", **{**_tiny_configs(name), "dtype": dtype})
            if ip:
                _attach_ip(s, types.SimpleNamespace(), tiny=True)
            built[key] = s
        return built[key]

    return get


@pytest.fixture(scope="module")
def jax_scorer():
    """The JAX scorer of ``tests/test_hbm_guard.py``'s tiny setup."""
    from diffsim_tpu.metrics.diffsim_sd15 import DiffSimSD15 as JaxSD15
    from diffsim_tpu.models import clip_text, unet, vae

    return JaxSD15(unet_cfg=unet.UNetConfig.tiny(), vae_cfg=vae.VAEConfig.tiny(),
                   text_cfg=clip_text.CLIPTextConfig.tiny(), img_size=32, dtype=np.float32)


def _pix(seed, n, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    return rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def _budget_for(monkeypatch, static: float, per_pair: float, margin: float) -> None:
    """Set DIFFSIM_TPU_HBM_GB so that the estimate of 4.5 pairs fills the usable budget."""
    monkeypatch.setenv("DIFFSIM_TPU_HBM_GB", str((static + 4.5 * per_pair) / margin / 1e9))


def _port_budget(monkeypatch, s) -> None:
    _budget_for(monkeypatch, hbm_guard.scorer_static_bytes(s), hbm_guard.per_pair_bytes(s),
                hbm_guard.MARGIN)


def _no_module(*_, **__):
    pytest.fail("a module ran in a refused call")


def _refuses_8_and_scores_4(monkeypatch, s, modules, **args):
    """Under the 4.5-pair budget: 8 pairs raise before any of ``modules`` runs (their
    ``forward`` and ``penultimate`` fail); 4 pairs score, as they do with the guard off."""
    a, b = _pix(1, 8), _pix(2, 8)
    _port_budget(monkeypatch, s)
    with monkeypatch.context() as m:
        for module in modules:
            m.setattr(module, "forward", _no_module)
            if hasattr(module, "penultimate"):
                m.setattr(module, "penultimate", _no_module)
        with pytest.raises(HbmBudgetError,
                           match=r"8-pair call at 32px.*--batch_size.*DIFFSIM_TPU_HBM_GB"):
            s.score_batch(a, b, **args)
    scores = s.score_batch(a[:4], b[:4], **args)
    assert scores.shape == (4,) and np.isfinite(scores).all()
    monkeypatch.setenv("DIFFSIM_TPU_HBM_GB", "0")
    np.testing.assert_array_equal(s.score_batch(a[:4], b[:4], **args), scores)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "float32"])
@pytest.mark.parametrize("name", list(CLASSES))
def test_score_batch_refuses_an_over_budget_batch_before_any_module_runs(monkeypatch, scorer,
                                                                          name, dtype):
    s = scorer(name, dtype)
    _refuses_8_and_scores_4(monkeypatch, s, [s.vae], **ARGS[name])


@pytest.mark.parametrize("name", ["diffsim", "diffsim_xl"])
def test_the_ip_adapter_pair_path_is_checked_too(monkeypatch, scorer, name):
    """The IP-Adapter taps run only on the pair path; the image encoder and the projection head
    are static bytes of the scorer."""
    s = scorer(name, ip=True)
    ip_bytes = hbm_guard.module_bytes(s.ip_encoder, s.ip_proj,
                                      *(attn.ip for attn in attn2_modules(s.unet)))
    assert hbm_guard.scorer_static_bytes(s) == (hbm_guard.scorer_static_bytes(scorer(name))
                                                + ip_bytes)
    _refuses_8_and_scores_4(monkeypatch, s, [s.vae, s.ip_encoder], ip_adapter=True,
                            **ARGS[name])


@pytest.mark.parametrize("transport", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_the_port_refuses_the_pair_counts_the_jax_scorer_refuses(monkeypatch, scorer,
                                                                 jax_scorer, transport):
    """The JAX scorer and the port's, each under a budget at its own static bytes plus 4.5 of
    its own pairs, accept 1-4 pairs and refuse 5-8; ``score_batch`` of 8 raises in both."""
    port = scorer("diffsim")
    itemsize = np.dtype(transport).itemsize

    def decisions(check):
        out = []
        for n in range(1, 9):
            try:
                check(n)
                out.append(True)
            except (HbmBudgetError, jax_guard.HbmBudgetError):
                out.append(False)
        return out

    a, b = _pix(3, 8, transport), _pix(4, 8, transport)
    _budget_for(monkeypatch, jax_guard.scorer_static_bytes(jax_scorer),
                jax_guard.per_triplet_bytes(32) * (2 / 3), jax_guard.MARGIN)
    jax_said = decisions(lambda n: jax_guard.check_pairs(jax_scorer, n, itemsize))
    with pytest.raises(jax_guard.HbmBudgetError, match="8-pair"):
        jax_scorer.score_batch(a, b, prompt="p", target_step=600)
    _port_budget(monkeypatch, port)
    port_said = decisions(lambda n: hbm_guard.check_pairs(port, n))
    with pytest.raises(HbmBudgetError, match="8-pair"):
        port.score_batch(a, b, **ARGS["diffsim"])
    assert port_said == jax_said == [True] * 4 + [False] * 4


@pytest.mark.parametrize("budget", ["0", "-1", None], ids=["zero", "negative", "unset"])
def test_the_guard_is_off_at_a_budget_of_zero_and_on_the_cpu_without_one(monkeypatch, scorer,
                                                                          budget):
    """A budget <= 0 turns the guard off, and so does a CPU device without the variable: a
    batch whose estimate exceeds any card still scores."""
    if budget is None:
        monkeypatch.delenv("DIFFSIM_TPU_HBM_GB", raising=False)
    else:
        monkeypatch.setenv("DIFFSIM_TPU_HBM_GB", budget)
    s = scorer("dit")
    assert hbm_guard.budget_bytes(s.device) <= 0
    hbm_guard.check_pairs(s, 10**9)
    assert s.score_batch(_pix(5, 8), _pix(6, 8), **ARGS["dit"]).shape == (8,)


@pytest.mark.parametrize("cls, img_size", PUBLISHED, ids=["sd15", "sdxl", "dit"])
def test_a_float32_scorers_pair_tail_is_float32_scale_times_its_bf16_one(cls, img_size):
    """A pair's tail is 2/3 of a triplet's (2 images and 4 CFG forwards against 3 and 6), which
    carries ``FLOAT32_SCALE`` for a float32 scorer; its pixels are uploaded alike in either
    dtype."""
    def tail(dtype):
        s = types.SimpleNamespace(hbm_scale=cls.hbm_scale, img_size=img_size, dtype=dtype)
        pixels = 2 * img_size * img_size * 3 * hbm_guard.PAIR_PIXEL_BYTES
        assert hbm_guard.per_pair_bytes(s) - pixels == pytest.approx(
            hbm_guard.per_triplet_bytes(s) * 2 / 3)
        return hbm_guard.per_pair_bytes(s) - pixels

    assert tail(torch.float32) == pytest.approx(hbm_guard.FLOAT32_SCALE * tail(torch.bfloat16))


# the pair tails' slopes that chip_smoke.py measured between two pair counts (bytes a pair after
# the last VAE encode slice; NVIDIA H100 80GB HBM3, 700 W), the IP-Adapter paths' beside their
# backbones': (scorer class, image size, dtype, slope)
PAIR_SLOPES = {"sd15": (DiffSimSD15, 512, torch.bfloat16, 0.2314e9),
               "sd15-ip": (DiffSimSD15, 512, torch.bfloat16, 0.2315e9),
               "sd15-float32": (DiffSimSD15, 512, torch.float32, 0.2983e9),
               "sdxl": (DiffSimXL, 1024, torch.bfloat16, 0.5092e9),
               "sdxl-ip": (DiffSimXL, 1024, torch.bfloat16, 0.5087e9),
               "sdxl-float32": (DiffSimXL, 1024, torch.float32, 0.8814e9),
               "dit": (DiffSimDiT, 512, torch.bfloat16, 0.1138e9),
               "dit-float32": (DiffSimDiT, 512, torch.float32, 0.2276e9)}


@pytest.mark.parametrize("cls, img_size, dtype, slope", PAIR_SLOPES.values(),
                         ids=PAIR_SLOPES.keys())
def test_the_pair_estimate_stays_above_each_measured_slope(cls, img_size, dtype, slope):
    """Each pair path's per-pair estimate stays above the slope measured on the card with the
    margin of the per-triplet constants (at least 10 %); the IP-Adapter's tower adds bytes that
    the guard counts as static, not a pair's."""
    s = types.SimpleNamespace(hbm_scale=cls.hbm_scale, img_size=img_size, dtype=dtype)
    assert hbm_guard.per_pair_bytes(s) >= 1.1 * slope


def _two_rank_adapter(monkeypatch, rank: int):
    """The tiny DiT metric's adapter as ``build_metric`` wraps it on rank ``rank`` of a group
    of two (``mesh.world`` patched; no collective is set up, so a gather fails the test)."""
    from diffsim_tpu_torch.cli.args import arg_parse
    from diffsim_tpu_torch.metrics import registry
    from diffsim_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "world", lambda: (rank, 2))
    monkeypatch.setattr(mesh, "check_same_weights", lambda *_, **__: None)
    monkeypatch.setattr(mesh, "gather_rows", _no_module)
    return registry.build_metric(arg_parse(["--metric", "dit", "--model_scale", "tiny",
                                            "--image_size", "32", "--target_layer", "0",
                                            "--target_step", "600"]), device="cpu")


@pytest.mark.parametrize("rank", [0, 1])
def test_every_rank_refuses_a_call_whose_largest_block_is_over_budget(monkeypatch, rank):
    """7 pairs over two ranks are blocks of 4 (rank 0) and 3 (rank 1). Under a budget of the
    scorer's static bytes plus 3.5 pairs only rank 0's block is over, yet both ranks raise
    before either calls ``score_batch`` or the gather, as JAX's ``check_pairs`` refuses one
    padded P on every process. Under static plus 4.5 pairs each rank scores its own block."""
    from diffsim_tpu_torch.parallel import mesh

    adapter = _two_rank_adapter(monkeypatch, rank)
    s = adapter.scorer
    monkeypatch.setattr(s, "score_batch", _no_module)
    static, per = hbm_guard.scorer_static_bytes(s), hbm_guard.per_pair_bytes(s)
    monkeypatch.setenv("DIFFSIM_TPU_HBM_GB", str((static + 3.5 * per) / hbm_guard.MARGIN / 1e9))
    hbm_guard.check_pairs(s, 3)  # rank 1's block alone would pass
    a, b = _pix(7, 7), _pix(8, 7)
    with pytest.raises(HbmBudgetError, match="4-pair call at 32px"):
        adapter.score_pairs(a, b, [""] * 7)
    assert adapter.score_pairs.rows == 0

    scored = []

    def score_batch(pa, pb, blocking=True, **_):
        scored.append(len(pa))
        return lambda: np.zeros(len(pa), np.float32)

    monkeypatch.setattr(s, "score_batch", score_batch)
    monkeypatch.setattr(mesh, "gather_rows", lambda local, n: torch.zeros(n))
    _port_budget(monkeypatch, s)
    assert adapter.score_pairs(a, b, [""] * 7).shape == (7,)
    assert scored == [4 - rank]
