"""Why K4's float32 kernel takes three TF32 products: an emulation on the CPU.

``csrc/streaming_attention.cu`` runs Q K^T and P V on the tensor cores in TF32, splitting each
float32 operand into hi = tf32(x), rounded to nearest with ties away from zero (``cvt.rna``'s
rounding), and lo = x - hi, which the tensor cores truncate to TF32, and taking
a_lo b_hi + a_hi b_lo + a_hi b_hi with float32 accumulation. Here TF32 rounding is emulated by
masking the float32 bits, the kernel's arithmetic is repeated in torch, and the result is held
to ``streaming_self_attention_plain`` within the card's float32 limit (atol 1e-5, rtol 0). One
TF32 pass misses that limit.
"""

import numpy as np
import pytest
import torch

from diffsim_tpu_torch.ops.kernels.attention_stream import streaming_self_attention_plain

ATOL = 1e-5  # chip_smoke.py's float32 limit for K4 against its plain version


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away from zero: add half
    of the 13 dropped bits' unit to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 operand: its top 19 bits (TF32, truncated)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """The kernel's split: hi rounded to nearest, lo = x - hi (exact), truncated on use."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on TF32 tensor cores with float32 accumulation: 3 passes (hi hi + hi lo + lo hi)
    or one (hi hi). TF32 products are exact in float32, so float32 matmuls emulate them."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def emulated_kernel(q, k, v, passes: int) -> torch.Tensor:
    """K4's float32 arithmetic with its products in ``passes`` TF32 passes: f32 logits, the row
    max over the unscaled logits, the scale in exp's operand, P V with 1/rowsum applied last."""
    scale = q.shape[-1] ** -0.5
    logits = product(q, k.transpose(-1, -2), passes)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp((logits - m) * scale)
    return product(e, v, passes) / e.sum(dim=-1, keepdim=True)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(3)]


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11),
                      1.0 + 2.0**-12, 3.0e-5], dtype=torch.float32)
    r = tf32_rna(x)
    assert r.tolist()[:5] == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9, -(1.0 + 2.0**-10), 1.0]
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = split(x[:5])
    assert torch.equal(hi + lo, x[:5])  # these split exactly into two TF32 values
    assert tf32_trunc(torch.tensor([1.0 + 2.0**-10 + 2.0**-11])).item() == 1.0 + 2.0**-10


@pytest.mark.parametrize("s", [1024, 1088])
def test_three_tf32_products_meet_the_float32_limit(s):
    q, k, v = _qkv((1, 1, s, 512), seed=s)
    ref = streaming_self_attention_plain(q, k, v)
    err = (emulated_kernel(q, k, v, passes=3) - ref).abs().max().item()
    assert err <= ATOL / 4, err  # inside the limit with room for the card's summation order


def test_one_tf32_product_misses_the_float32_limit():
    q, k, v = _qkv((1, 1, 1024, 512), seed=1024)
    ref = streaming_self_attention_plain(q, k, v)
    err = (emulated_kernel(q, k, v, passes=1) - ref).abs().max().item()
    assert err > ATOL, err
