"""K2's and K3's float32 designs on the CPU: their arithmetic repeated in torch, held to the
plain versions within the limits ``chip_smoke.py`` holds the kernels to on the card.

Both run 3xTF32 on the tensor cores with the split, product order and truncating tensor-core
sums of ``tests/test_torch_port_k1_tf32x3.py`` (each mma.m16n8k8 step adds its eight products to
the running float32 sum exactly and truncates the result towards zero):

* K2 (``csrc/geglu_ff.cu``): two GEMMs whose every 32-column k panel is a fresh tensor-core sum
  (4 k8 steps of 3 products), added to the float32 accumulator with one rounded add; b1, the
  erf GEGLU epilogue and b2 in float32, y kept in float32. Within a twentieth of the card's limit
  (atol = rtol = 1e-4 against ``fused_geglu_ff_plain``) at c = 320 and 640; one running sum
  over all of k (GEMM2's 960 truncating steps at c = 640) is at least five times further off,
  and one TF32 pass misses the limit.
* K3 (``csrc/fused_readout_f32.cu``): K1's float32 pass (``attention_tf32.cuh``) over the cross
  keys and then the self keys of one Q tile, each output normalised by its row sums, then the
  partials; the scores within a third of the card's limit (|d| <= 1e-5 and <= 1e-5 of the
  distance against ``fused_direction_score_plain``); one TF32 pass misses it.
"""

import types

import numpy as np
import pytest
import torch

from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff_plain
from diffsim_tpu_torch.ops.kernels.readout import (
    _direction_score,
    _partials,
    fused_direction_score_plain,
)
from diffsim_tpu_torch.runtime import hbm_guard
from tests.test_torch_port_k1_tf32x3 import emulated_kernel, mma_sum, passes_of

K2_TOL = 1e-4  # chip_smoke.py's float32 limit for K2 against its plain version, atol = rtol
K3_TOL = 1e-5  # and for K3's scores: atol, and rtol of the distance
PANEL = 32  # k columns of one fresh tensor-core sum in K2's float32 GEMMs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small matrix products run faster on one intra-op thread than on many, most of all while
    the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def emulated_gemm(a, w, passes: int, panel: int | None):
    """a @ w.T as K2's float32 GEMMs take it: each ``panel`` k columns a fresh tensor-core sum in
    ``passes`` TF32 products, added to the float32 accumulator with one rounded add (``panel``
    None: one running sum over all of k)."""
    k = a.shape[1]
    panel = panel or k
    acc = torch.zeros((a.shape[0], w.shape[0]))
    for p0 in range(0, k, panel):
        cols = slice(p0, p0 + panel)
        acc = acc + mma_sum(torch.zeros_like(acc), *passes_of(a[:, cols], w[:, cols].T, passes))
    return acc


def emulated_ff(x, w1, b1, w2, b2, passes: int = 3, panel: int | None = PANEL):
    h, g = (emulated_gemm(x, w1, passes, panel) + b1).chunk(2, dim=-1)
    y = h * (0.5 * g * (1.0 + torch.erf(g * 0.7071067811865476)))
    return emulated_gemm(y, w2, passes, panel) + b2


def _ff_args(c: int, n: int = 64):
    """chip_smoke.py's K2 inputs at a narrow row count: x N(0, 1), W1 N(0, 1/c), W2
    N(0, 1/4c), biases N(0, 0.01)."""
    rng = np.random.default_rng(c)

    def draw(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return (draw((n, c), 1.0), draw((8 * c, c), c**-0.5), draw((8 * c,), 0.1),
            draw((c, 4 * c), (4 * c) ** -0.5), draw((c,), 0.1))


def _ff_share(args, **kw) -> float:
    """The emulation's largest error as a share of the card's limit, atol + rtol |plain|."""
    ref = fused_geglu_ff_plain(*args)
    return ((emulated_ff(*args, **kw) - ref).abs() / (K2_TOL + K2_TOL * ref.abs())).max().item()


@pytest.mark.parametrize("c", [320, 640])
def test_k2_three_tf32_passes_a_fresh_sum_a_panel_stay_far_inside_the_card_limit(c):
    assert _ff_share(_ff_args(c)) <= 0.05


def test_k2_one_running_sum_over_all_of_k_loses_more_than_the_panel_sums():
    args = _ff_args(640)
    assert _ff_share(args, panel=None) >= 5 * _ff_share(args)


def test_k2_one_tf32_pass_misses_the_card_limit():
    assert _ff_share(_ff_args(320), passes=1) > 1.0


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def emulated_partials(passes: int):
    """K3's float32 kernel on (N, S, D) rows: the cross pass and the self pass of K1's float32
    arithmetic (``emulated_kernel``: 64-key tiles, online softmax, a fresh P V sum a tile, the
    output times 1 / l), then the partials."""
    def partials(q, k_cross, v_cross, k_self, v_self, mse=False):
        o1 = emulated_kernel(q[None], k_cross[None], v_cross[None], passes)[0]
        o2 = emulated_kernel(q[None], k_self[None], v_self[None], passes)[0]
        return _partials(o1, o2, mse)
    return partials


def _taps(shape):
    """chip_smoke.py's K3 inputs: image B's keys and values are image A's plus 0.3 x noise, so
    that the cosines sit near 0.9, where DiffSim's do."""
    rng = np.random.default_rng(sum(shape))

    def draw():
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    qa, ka, va = draw(), draw(), draw()
    return qa, ka, va, ka + 0.3 * draw(), va + 0.3 * draw()


def _score_share(taps, similarity: str, passes: int) -> float:
    """The emulated score's largest error as a share of the card's limit: K3_TOL, and K3_TOL of
    the plain score's distance (1 - cosine, or the mse)."""
    ref = fused_direction_score_plain(*taps, similarity)
    out = _direction_score(emulated_partials(passes), *taps, similarity)
    dist = (1.0 - ref if similarity == "cosine" else ref).abs()
    return ((out - ref).abs() / torch.clamp(K3_TOL * dist, max=K3_TOL)).max().item()


# (P, B, H, S, D): the DiT-XL/2 tap's head dim 72 at 1024 tokens, SD-1.5's up-block-2 tap's 80,
# and SDXL's 64 at 512 tokens, narrow in P, B and H
K3_SHAPES = [(1, 2, 1, 1024, 72), (1, 2, 1, 1024, 80), (1, 2, 2, 512, 64)]


@pytest.mark.parametrize("shape", K3_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_k3_three_tf32_passes_stay_within_a_third_of_the_card_limit(shape, similarity):
    assert _score_share(_taps(shape), similarity, passes=3) <= 1 / 3


def test_k3_one_tf32_pass_misses_the_card_limit():
    assert _score_share(_taps((1, 2, 2, 512, 64)), "cosine", passes=1) > 1.0


# ---------------------------------------------------------------------------
# the device-memory guard of the float32 scorers
# ---------------------------------------------------------------------------


def test_the_guard_counts_more_bytes_a_triplet_for_a_float32_scorer():
    """The guard's per-triplet constant was measured on a bf16 scorer; a float32 scorer's
    scoring tail holds more bytes a triplet (``chip_smoke.py`` measures the float32 SD-1.5
    scorer's slope and holds the guard above it)."""
    def scorer(dtype):
        return types.SimpleNamespace(hbm_scale=1.7, img_size=1024, dtype=dtype)

    bf16 = hbm_guard.per_triplet_bytes(scorer(torch.bfloat16))
    assert bf16 == hbm_guard.PER_TRIPLET_BYTES_512 * 1.7 * 4
    assert hbm_guard.per_triplet_bytes(scorer(torch.float32)) == hbm_guard.FLOAT32_SCALE * bf16
    assert hbm_guard.FLOAT32_SCALE > 1.0


# the float32 scoring tails' slopes that chip_smoke.py measured between two triplet counts
# (bytes a triplet; NVIDIA H100 80GB HBM3, 700 W): (scorer class, image size, slope)
FLOAT32_SLOPES = [("DiffSimSD15", 512, 0.438e9), ("DiffSimXL", 1024, 1.284e9),
                  ("DiffSimDiT", 512, 0.3411e9)]


@pytest.mark.parametrize("name, img_size, slope", FLOAT32_SLOPES)
def test_the_guard_holds_each_float32_scorer_above_its_measured_slope(name, img_size, slope):
    """A float32 scorer's per-triplet constant stays above the slope measured on the card, with
    the margin of the bf16 constants (at least 10 %); the scale of 1.5 held SD-1.5 alone, and
    SDXL's and DiT-XL/2's tails outgrew it."""
    from diffsim_tpu_torch.metrics import diffsim_dit, diffsim_sd15, diffsim_xl

    cls = {"DiffSimSD15": diffsim_sd15.DiffSimSD15, "DiffSimXL": diffsim_xl.DiffSimXL,
           "DiffSimDiT": diffsim_dit.DiffSimDiT}[name]
    scorer = types.SimpleNamespace(hbm_scale=cls.hbm_scale, img_size=img_size,
                                   dtype=torch.float32)
    assert hbm_guard.per_triplet_bytes(scorer) >= 1.1 * slope
