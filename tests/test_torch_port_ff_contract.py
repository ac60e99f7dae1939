"""K2's shape contract and its erf, on the CPU.

The CUDA kernels of ``csrc/geglu_ff.cu`` take the shapes that ``ff.kernel_takes`` admits; the
wrapper raises for any other. A shape that ``routes.use_fused_ff`` sends to K2 but the kernels
refuse would raise on the card, so every routed (rows, C) of the UNet configs, at the batches
``chip_smoke.py`` runs them, must be admitted, and so must chip_smoke.py's ragged shapes. The bf16
kernel evaluates erf with the Abramowitz & Stegun 7.1.26 approximation of the TPU kernel; its
coefficients are read out of the CUDA source here and the formula is held to ``torch.erf``.
"""

import os
import re

import pytest
import torch

from diffsim_tpu_torch.models.unet import UNetConfig
from diffsim_tpu_torch.ops.kernels import build, ff, routes

# (config, image px, UNet rows per forward) as chip_smoke.py drives them: a triplet call, a
# 2-pair score_batch and a one-pair call at full width; the tiny card-vs-CPU scorers
RUNS = [
    (UNetConfig.sd15(), 512, (24, 8, 4)),
    (UNetConfig.sdxl(), 1024, (12, 8, 4)),
    (UNetConfig.tiny(), 32, (16,)),
    (UNetConfig.tiny_xl(64), 256, (4,)),
]
RAGGED = [(8, 32), (300, 32), (1000, 64), (136, 160), (24 * 256, 1280)]  # chip_smoke.py's


def ff_sites(cfg: UNetConfig, px: int, rows: int):
    """(rows x tokens, C) of every transformer feed-forward of the UNet: the down blocks with
    transformers, the mid block (the up path repeats the down path's widths)."""
    latent = px // 8
    n_blocks = len(cfg.block_out_channels)
    for i, (c, depth) in enumerate(zip(cfg.block_out_channels, cfg.transformer_depth)):
        if depth:
            yield rows * (latent >> i) ** 2, c
    if cfg.mid_transformer_depth:
        yield rows * (latent >> (n_blocks - 1)) ** 2, cfg.block_out_channels[-1]


@pytest.mark.parametrize("cfg,px,batches", RUNS)
def test_every_routed_ff_shape_is_one_the_kernels_take(cfg, px, batches):
    routed = [(n, c) for rows in batches for n, c in ff_sites(cfg, px, rows)
              if routes.use_fused_ff(n, c, 8 * c)]
    assert routed  # each config routes some sites to K2
    for n, c in routed:
        assert ff.kernel_takes(n, c), (n, c)


@pytest.mark.parametrize("n,c", RAGGED)
def test_ragged_shapes_are_ones_the_kernels_take(n, c):
    assert ff.kernel_takes(n, c)


@pytest.mark.parametrize("n,c", [(64, 48), (64, 0), (0, 32), (65536 * 64, 32), (64, 640 + 16)])
def test_the_contract_refuses_what_the_kernels_cannot_take(n, c):
    assert not ff.kernel_takes(n, c)


def _as_coefficients() -> list[float]:
    """The float literals of ``gelu_as`` in the CUDA source, in order of appearance."""
    with open(os.path.join(build.CSRC_DIR, "geglu_ff.cu")) as f:
        src = f.read()
    body = src[src.index("float gelu_as(float g)"):]
    body = body[:body.index("\n}\n")]
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?(?=f)", body)]


def test_the_kernels_erf_is_the_tpu_kernels_within_its_bound():
    # g / sqrt 2; t = 1 / (p |x| + 1); poly(t) by Horner from a5 down to a1; 1 - poly e^-x^2; 0.5 g
    inv_sqrt2, p, one, a5, a4, a3, a2, a1, one_, half = _as_coefficients()
    assert (inv_sqrt2, one, one_, half) == (0.70710678118654752, 1.0, 1.0, 0.5)
    assert (a1, a2, a3, a4, a5, p) == (0.254829592, -0.284496736, 1.421413741, -1.453152027,
                                       1.061405429, 0.3275911)  # diffsim_tpu/ops/pallas/ff.py
    x = torch.linspace(-6.0, 6.0, 200001, dtype=torch.float64)
    t = 1.0 / (1.0 + p * x.abs())
    poly = t * ((((a5 * t + a4) * t + a3) * t + a2) * t + a1)
    erf = torch.sign(x) * (1.0 - poly * torch.exp(-x * x))
    assert (erf - torch.erf(x)).abs().max().item() <= 1.5e-7
