"""Shape predicates that decide which sites run a hand-written kernel.

They are the shape parts of the JAX package's route predicates, ported exactly:
``use_fused`` (``diffsim_tpu/ops/pallas/attention.py``), ``use_fused_ff``
(``ops/pallas/ff.py``), ``use_fused_readout`` (``ops/pallas/readout.py``) and
``use_streaming`` (``ops/pallas/attention_stream.py``). The JAX package's platform gate
(``pallas_route``) becomes the tensor's device in the port: a CPU tensor runs the kernel's
plain version, a CUDA tensor launches the kernel. The ``DIFFSIM_TPU_NO_PALLAS`` kill switch is
deliberately absent.
"""

from __future__ import annotations

MIN_FUSED_SEQ = 256  # K1: every square self-attention site with >= 256 tokens
MAX_FUSED_DIM = 640  # K2: the TPU kernel keeps W1 (c x 8c) in VMEM
MIN_STREAM_SEQ = 8192  # K4: the 1024 px VAE mid attention


def use_fused(q_shape, k_shape) -> bool:
    """K1 ``fused_self_attention``: square self-attention, S >= 256, S % 256 == 0, D <= 160."""
    return (
        q_shape[-2] == k_shape[-2]
        and q_shape[-2] >= MIN_FUSED_SEQ
        and q_shape[-2] % 256 == 0
        and q_shape[-1] <= 160
    )


def _block_rows(n: int, c: int) -> int:
    """The JAX kernel's row tile: the largest power of two <= 512 (256 for c > 320) that
    divides n."""
    bq = 512 if c <= 320 else 256
    while bq > 1 and n % bq:
        bq //= 2
    return bq


def use_fused_ff(n: int, c: int, w1_cols: int) -> bool:
    """K2 ``fused_geglu_ff``: c <= 640, W1 has 8c columns, and a row tile of >= 8 divides n."""
    return c <= MAX_FUSED_DIM and w1_cols == 8 * c and _block_rows(n, c) >= 8


def use_fused_readout(q_shape) -> bool:
    """K3 ``fused_direction_score`` for (P, B, H, S, D) taps: S >= 512, S % 512 == 0,
    D <= 128."""
    p, b, h, s, d = q_shape
    return s >= 512 and s % 512 == 0 and d <= 128


def use_streaming(q_shape, k_shape) -> bool:
    """K4 ``streaming_self_attention``: square wide-head attention, S >= 8192,
    S % 256 == 0, 160 < D <= 1024."""
    s, d = q_shape[-2], q_shape[-1]
    return q_shape[-2] == k_shape[-2] and s >= MIN_STREAM_SEQ and s % 256 == 0 and 160 < d <= 1024

