"""The bf16_probs mode's probability arithmetic as the CUDA kernels take it, on the CPU.

``csrc/attention_common.cuh`` ``prob_bf16x2`` rounds two centred logits s - m to bf16 with one
conversion, multiplies both by the bf16 scale with one packed bf16 multiply (rounded once),
takes exp2 of each product times log2 e in float32 on the special-function unit
(``ex2.approx.ftz``, which flushes a result below float32's smallest normal to zero), and rounds
both probabilities to bf16 where it packs them for P V. Here that sequence, emulated in torch
for every bf16 centred logit <= 0, equals the earlier scalar form (each rounding taken of a
float32 value) bit for bit, the JAX kernel's rounding (``diffsim_tpu/ops/pallas/attention.py``
lines 51-55, run op by op in bf16) and ``chip_smoke.py``'s ``rounded_probs_reference`` formula.

The new bf16 K4 kernel (``csrc/streaming_attention.cu``) takes 64-key tiles whose scores two
consumer warpgroups split, 32 keys each, and its mode rounds the row sum of each consumer's 32
keys: its emulation passes ``chip_smoke.check_rounding`` at ``sum_tile=32``
(``chip_smoke.K4_SUM_TILE``) and fails it at the tile's 64 keys, and rounding the whole tile's
sum fails at 32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffsim_tpu_torch.ops.kernels.attention import round_bf16

TINY = 2.0**-126  # float32's smallest normal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small matrix products run faster on one intra-op thread than on many, most of all while
    the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _centred_logits() -> np.ndarray:
    """Every bf16 value <= 0 as float32: +0, then -0 down to -inf (the NaNs left out)."""
    bits = np.concatenate([np.zeros(1, np.uint32), np.arange(0x8000, 0xFF81, dtype=np.uint32)])
    return (bits << 16).view(np.float32)


def _kernel_pairs(centred: torch.Tensor, scale_bf16: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``prob_bf16x2`` in torch: the bf16 product of the bf16 logit and scale (torch multiplies
    two bf16 tensors exactly in float32 and rounds once), float32 exp2 with the flush to zero,
    and the probabilities rounded to bf16. Returns the products and the probabilities."""
    x = centred.to(torch.bfloat16) * torch.tensor(scale_bf16, dtype=torch.bfloat16)
    p32 = torch.exp2(x.float() * chip_smoke.LOG2E)
    p32 = torch.where(p32 < TINY, torch.zeros_like(p32), p32)
    return x.float(), round_bf16(p32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("d", [40, 72, 80, 160, 512])
def test_pair_arithmetic_equals_the_scalar_form_jax_and_the_reference(d):
    c32 = _centred_logits()
    centred = torch.from_numpy(c32)
    scale = d**-0.5
    scale_bf16 = round_bf16(torch.tensor(scale)).item()
    x, p = _kernel_pairs(centred, scale_bf16)

    # the earlier scalar form: each rounding of a float32 value, the product taken in float32
    assert np.array_equal(_bits(x), _bits(round_bf16(round_bf16(centred) * scale_bf16)))

    # the JAX kernel's lines: centered.astype(bf16); exp(centered * scale), each op in bf16.
    # XLA's CPU code flushes a float32 product or exponential below the smallest normal to zero;
    # a product that small gives the probability 1 either way, and the kernel's ex2.approx.ftz
    # flushes the exponential as XLA does
    xj = jnp.asarray(c32).astype(jnp.bfloat16) * scale
    pj = np.asarray(jnp.exp(xj).astype(jnp.float32))
    xj = np.asarray(xj.astype(jnp.float32))
    tiny_product = np.abs(c32.astype(np.float64) * scale_bf16) < TINY
    assert np.array_equal(_bits(xj)[~tiny_product], _bits(x)[~tiny_product])
    assert (xj[tiny_product] == 0).all() and (p.numpy()[tiny_product] == 1).all()
    # XLA's exp and exp2 of the product times log2 e differ by float32 ulps (the multiply's
    # rounding grows with |x|): the bf16 roundings may differ only where the float32 value lies
    # that close to a bf16 rounding midpoint
    p32 = torch.exp2(x * chip_smoke.LOG2E).double()
    delta = 2.0**-21 + x.abs().double() * 2.0**-23
    near_midpoint = (round_bf16((p32 * (1 - delta)).float())
                     != round_bf16((p32 * (1 + delta)).float())).numpy()
    differ = _bits(pj) != _bits(p)
    assert not (differ & ~near_midpoint).any(), c32[differ & ~near_midpoint][:8]
    assert near_midpoint.sum() <= 8  # a handful of the 32642 logits
    assert (p > 0).sum() > 17000  # and the comparison is not one of zeros

    # rounded_probs_reference's formula, which keeps float32 subnormals the kernel flushes
    ref32, ref = chip_smoke.mode_probs(centred, scale_bf16)
    normal = (ref32 >= TINY).numpy()
    assert np.array_equal(_bits(ref)[normal], _bits(p)[normal])
    assert (ref[~normal] < TINY).all() and (p[~normal] == 0).all()


TILE = 64  # keys of a tile of the new bf16 K4 kernel: one running max per tile


def _k4_bf16_emulated(q, k, v, fast: bool, sum_keys: int):
    """The new bf16 K4 kernel's online softmax in float32: 64-key tiles, the scale times log2 e
    folded into exp2 against the running max, the probabilities cast to bf16 for P V; in the
    mode (``_kernel_pairs`` via ``chip_smoke.mode_probs``) the row sums of each ``sum_keys``
    keys rounded to bf16 before they enter l."""
    b, h, s, d = q.shape
    scale = d**-0.5
    c = torch.tensor(scale * chip_smoke.LOG2E, dtype=torch.float32).item()
    scale_bf16 = round_bf16(torch.tensor(scale)).item()
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, s, 1), -float("inf"))
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for j in range(0, s, TILE):
        sc = qf @ kf[:, :, j:j + TILE].transpose(-1, -2)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)  # 0 on the first tile
        if fast:
            p = chip_smoke.mode_probs(sc - m_new, scale_bf16)[1]
            sums = p.reshape(b, h, s, TILE // sum_keys, sum_keys).sum(-1)
            tile_sum = round_bf16(sums).sum(-1, keepdim=True)
        else:
            p = torch.exp2(sc * c - m_new * c)
            tile_sum = p.sum(-1, keepdim=True)
        l = l * corr + tile_sum
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :, j:j + TILE]
        m = m_new
    return (acc / l).to(v.dtype)


@pytest.mark.parametrize("sum_keys,sum_tile,passes", [(32, 32, True), (32, 64, False),
                                                      (64, 32, False)],
                         ids=["slices_at_32", "slices_at_64", "tiles_at_32"])
def test_k4_bf16_mode_rounds_each_consumer_slice(sum_keys, sum_tile, passes):
    assert chip_smoke.K4_SUM_TILE[torch.bfloat16] == 32
    gen = torch.Generator()
    gen.manual_seed(0)

    def kernel(q, k, v, fast):
        return _k4_bf16_emulated(q, k, v, fast, sum_keys)

    def check():
        return chip_smoke.check_rounding(f"K4 bf16 {sum_keys}-key sums", kernel,
                                         (1, 1, 1024, 256), torch.bfloat16, gen, sum_tile)

    if passes:
        res = check()
        assert res["disagreement"] <= 0.1 * res["exact_disagreement"]
    else:
        with pytest.raises(SystemExit, match="does not round as the mode does"):
            check()
