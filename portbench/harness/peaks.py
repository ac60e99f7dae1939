"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
power limit) and the least time a piece of work could take on it: the arithmetic of
``chip_smoke.py``'s ``bound()``, copied here as the benchmark's own yardstick."""

from __future__ import annotations

PEAK_BF16 = 989e12  # bf16 tensor-core FLOP/s
PEAK_TF32 = 495e12  # TF32 tensor-core FLOP/s: a float32 product split into 3 TF32 passes
PEAK_EXP = 3.9e12  # exponentials/s of the special-function units (FlashAttention-3, section 1)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def bound_s(flops: float, nbytes: float, exps: float = 0.0, tf32_passes: float = 0.0) -> float:
    """The least seconds for the work: the largest of the products over their peak (bf16, or
    ``tf32_passes`` TF32 products per float32 product over the TF32 peak), the exponentials
    over the special-function rate and the bytes over the memory rate."""
    ops = tf32_passes * flops / PEAK_TF32 if tf32_passes else flops / PEAK_BF16
    return max(ops, exps / PEAK_EXP, nbytes / PEAK_BYTES)


def attention_bound_s(rows: float, heads: int, s: int, d: int, elem_bytes: int,
                      tf32_passes: float = 0.0) -> float:
    """Square self-attention over ``rows`` x ``heads`` heads of ``s`` tokens at head dim ``d``:
    Q K^T and P V (4 s^2 d FLOP a head), s^2 exponentials, Q, K, V read and O written once."""
    bh = rows * heads
    return bound_s(4.0 * bh * s * s * d, 4.0 * bh * s * d * elem_bytes, bh * s * s, tf32_passes)
