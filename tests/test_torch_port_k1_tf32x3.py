"""K1's float32 design on the CPU: its arithmetic repeated in torch, held to the plain version.

``csrc/fused_attention.cu`` runs float32 attention on the tensor cores as three TF32 products
(3xTF32, the split of ``tests/test_torch_port_tf32x3.py``): S = Q K^T over all of D into one
sum, the online softmax over 64-key tiles (exp2 with the scale times log2 e folded into one FMA
against the running max), and each tile's P V as a fresh sum, added to the rescaled
accumulator with one float32 FMA. The tensor cores truncate their float32 sums; here each
mma.m16n8k8 step adds its eight products to the running sum exactly and truncates the result
towards zero. The emulation stays within a quarter of the card's float32 limit (atol 1e-5
against ``fused_self_attention_plain``), and one TF32 pass misses that limit. In the bf16_probs
mode P is exact in bf16, so its TF32 low part is zero and two products give P V bit for bit as
three do.
"""

import numpy as np
import pytest
import torch

from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention_plain, round_bf16
from tests.test_torch_port_tf32x3 import split

ATOL = 1e-5  # chip_smoke.py's float32 limit for K1 against its plain version
BKV = 64  # keys per K/V tile
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small matrix products run faster on one intra-op thread than on many, most of all while
    the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded towards zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_sum(c, a_parts, b_parts):
    """c + sum_i a_i @ b_i over k8 steps as the tensor cores take it: per step of 8 k columns,
    one product of each (a, b) pair in order, each added to the running float32 sum exactly and
    truncated."""
    for j in range(0, a_parts[0].shape[-1], 8):
        for a, b in zip(a_parts, b_parts):
            c = trunc_f32(c.double() + a[..., j:j + 8].double() @ b[..., j:j + 8, :].double())
    return c


def passes_of(a, b, passes: int):
    """The (A, B) operand pairs of one float32 product: lo hi, hi lo, hi hi (small terms first,
    as the kernel orders them); hi hi alone for one pass; lo hi dropped for two, where A is
    exact in TF32."""
    ah, al = split(a)
    bh, bl = split(b)
    return {1: ([ah], [bh]), 2: ([ah, ah], [bl, bh]), 3: ([al, ah, ah], [bh, bl, bh])}[passes]


def emulated_kernel(q, k, v, passes: int = 3, bf16_probs: bool = False, pv_passes=None):
    """K1's float32 kernel in torch: Q K^T in ``passes`` TF32 passes into one sum per tile, the
    online softmax of ``attention_wgmma.cuh`` softmax_tile, P V per 64-key tile in
    ``pv_passes`` (default ``passes``) as a fresh sum, then acc = fma(acc, corr, part)."""
    pv_passes = passes if pv_passes is None else pv_passes
    b, h, s, d = q.shape
    scale = d**-0.5
    c = torch.tensor(scale * LOG2E, dtype=torch.float32).item()  # scale log2 e, in float32
    scale_bf16 = round_bf16(torch.tensor(scale)).item()
    m = torch.full((b, h, s, 1), -float("inf"))
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    zero = torch.zeros((b, h, s, BKV))
    for j in range(0, s, BKV):
        kt, vt = k[:, :, j:j + BKV], v[:, :, j:j + BKV]
        sc = mma_sum(zero, *passes_of(q, kt.transpose(-1, -2), passes))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)  # 0 on the first tile
        if bf16_probs:
            p = round_bf16(torch.exp2(round_bf16(round_bf16(sc - m_new) * scale_bf16) * LOG2E))
        else:
            p = torch.exp2((sc.double() * c - (m_new * c).double()).float())  # one FMA
        l = l * corr + p.sum(-1, keepdim=True)
        part = mma_sum(torch.zeros_like(acc), *passes_of(p, vt, pv_passes))
        acc = (acc.double() * corr.double() + part.double()).float()  # one rounding, an FMA
        m = m_new
    if bf16_probs:
        l = round_bf16(l)
    return acc * (1.0 / l)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(3)]


# the DiT training site's heads and tokens (one sample of its batch), SD-1.5's 1024-token sites
# at hd 80, the widest head at a ragged tile count, and the narrowest head
SHAPES = [(1, 16, 256, 72), (1, 4, 1024, 80), (1, 4, 192, 160), (1, 4, 64, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_three_tf32_passes_stay_within_a_quarter_of_the_card_limit(shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    err = (emulated_kernel(q, k, v) - fused_self_attention_plain(q, k, v)).abs().max().item()
    assert err <= ATOL / 4, err


def test_one_tf32_pass_misses_the_card_limit():
    q, k, v = _qkv((1, 16, 256, 72), seed=1)
    err = (emulated_kernel(q, k, v, passes=1)
           - fused_self_attention_plain(q, k, v)).abs().max().item()
    assert err > ATOL, err


def test_bf16_probabilities_have_no_tf32_low_part_so_two_passes_equal_three():
    q, k, v = _qkv((1, 4, 256, 72), seed=2)
    p = round_bf16(torch.rand((4, 64, 64)))
    assert torch.count_nonzero(split(p)[1]) == 0
    three = emulated_kernel(q, k, v, bf16_probs=True)
    two = emulated_kernel(q, k, v, bf16_probs=True, pv_passes=2)
    assert torch.equal(two, three)
    # and the mode is the plain version's bf16_probs mode, within bf16 rounding
    ref = fused_self_attention_plain(q, k, v, bf16_probs=True)
    assert (three - ref).abs().max().item() <= 1e-2
