"""Deterministic noise conventions.

One ``torch.Generator`` on the scoring device is seeded from ``seed`` for each score call, and
the four draws of a pair score run in the role order VAE_A, VAE_B, NOISE_A, NOISE_B. One draw
is shared by every pair of the batch, as the JAX scorer shares its role keys
(``diffsim_tpu/metrics/diffsim_sd15.py``). Torch and JAX generators give different numbers from
one seed; cross-framework tests hand both the same numpy noise (``noise_override``).
"""

from __future__ import annotations

import torch

VAE_A, VAE_B, NOISE_A, NOISE_B = 0, 1, 2, 3


def role_noise(seed: int, shape: tuple, device) -> list[torch.Tensor]:
    """Four float32 draws of ``shape`` in role order [VAE_A, VAE_B, NOISE_A, NOISE_B]."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            for _ in (VAE_A, VAE_B, NOISE_A, NOISE_B)]
