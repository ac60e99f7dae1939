"""VGG-16 / VGG-19 feature extractors (torchvision's ``.features`` layout), for LPIPS and the
VGG-Gram baseline, on cuDNN's convolutions.

Counterpart of ``diffsim_tpu/models/vgg.py``, in NCHW. On the card PyTorch's defaults hold:
cuDNN may run these float32 convolutions in TF32 (``torch.backends.cudnn.allow_tf32``), as the
reference's PyTorch did; the JAX package computes them in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# torchvision .features configs: numbers are conv output channels, 'M' is a 2x2 max pool
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# LPIPS's VGG-16 taps (torchvision module indices): relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
LPIPS_VGG16_TAPS = (3, 8, 15, 22, 29)
# VGG-Gram's tap: VGG-19's conv5_1 output, before its ReLU (torchvision index 28)
VGG19_CONV5_1 = 28


class VGG(nn.Module):
    """The conv stack of ``cfg``: 3x3 convolutions with padding 1, each followed by a ReLU, and
    2x2 max pools. Parameters ``convs.<i>.weight`` / ``bias``, the JAX tree's ``convs`` list."""

    def __init__(self, cfg=VGG19_CFG, in_channels: int = 3):
        super().__init__()
        self.cfg = list(cfg)
        convs, cin = [], in_channels
        for item in self.cfg:
            if item != "M":
                convs.append(nn.Conv2d(cin, item, 3, padding=1))
                cin = item
        self.convs = nn.ModuleList(convs)

    def features(self, x: torch.Tensor, taps: tuple[int, ...] = ()):
        """Run the stack on x (B, C, H, W); ``taps`` are torchvision module indices to capture,
        each the tensor as it is after that module (a conv's output, a ReLU's, a pool's).
        Returns (the final output, or None once every tap is taken, {index: tensor})."""
        out = {}
        max_tap = max(taps) if taps else None
        idx = 0
        convs = iter(self.convs)
        for item in self.cfg:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                steps = (x,)
            else:
                x = next(convs)(x)
                y = F.relu(x)
                steps, x = (x, y), y
            for value in steps:
                if idx in taps:
                    out[idx] = value
                idx += 1
            if max_tap is not None and idx > max_tap:
                return None, out
        return x, out
