"""LPIPS perceptual distance (the VGG-16 variant), on PyTorch: the reference's
``lpips.LPIPS(net='vgg')`` baseline. Lower is more similar.

Counterpart of ``diffsim_tpu/metrics/lpips.py``: the inputs pass the fixed shift / scale layer,
VGG-16 runs to its five relu stages, each tap is normalised to unit length over its channels,
weighted by the non-negative 1x1 ``lin`` weights, summed over channels and averaged over space,
and the five stages are summed. Inputs are [-1, 1] images (uint8 maps to [-1, 1] on the device).
The convolutions run on cuDNN with PyTorch's defaults (TF32 allowed on the card).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from diffsim_tpu_torch.metrics.scorer_base import build_module, fetchable, resolve_device
from diffsim_tpu_torch.models.vgg import LPIPS_VGG16_TAPS, VGG, VGG16_CFG

# the published LPIPS input scaling layer
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
STAGE_CHANNELS = (64, 128, 256, 512, 512)


class _Lin(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(channels))


class LPIPSNet(nn.Module):
    """The JAX tree {'vgg': VGG-16 ``convs``, 'lins': [{'w': (C,)}] * 5} (bridge kind
    ``lpips``)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG(VGG16_CFG)
        self.lins = nn.ModuleList(_Lin(c) for c in STAGE_CHANNELS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (2P, 3, H, W) in [-1, 1], A rows then B rows -> (P,) distances."""
        shift = torch.as_tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
        scale = torch.as_tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
        _, taps = self.vgg.features((x - shift) / scale, LPIPS_VGG16_TAPS)
        n = x.shape[0] // 2
        total = 0.0
        for idx, lin in zip(LPIPS_VGG16_TAPS, self.lins):
            f = taps[idx]
            f = f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)
            diff = (f[:n] - f[n:]) ** 2
            total = total + (diff * lin.w.reshape(1, -1, 1, 1)).sum(dim=1).mean(dim=(1, 2))
        return total


class LPIPS:
    """``params`` is the JAX tree {'vgg', 'lins'}, bridged strictly; if None, the weights are
    random, drawn on the device from seed 0 (the ``lins`` weights then all one). Float32."""

    def __init__(self, params=None, *, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.model = build_module(LPIPSNet, params, "lpips", self.device, torch.float32, gen)

    @torch.no_grad()
    def score_batch(self, pix_a, pix_b, blocking: bool = True):
        """(P,) LPIPS distances of NHWC pairs: uint8, or float in [-1, 1]."""
        pix = torch.from_numpy(np.concatenate([np.asarray(pix_a), np.asarray(pix_b)])).to(
            self.device)
        if pix.dtype == torch.uint8:
            pix = pix.float() / 127.5 - 1.0
        pix = pix.float().permute(0, 3, 1, 2).contiguous()
        return fetchable(self.model(pix), blocking)

    def __call__(self, pix_a, pix_b):
        return self.score_batch(pix_a, pix_b)
