"""U^2-Net salient-object matting (Qin et al., 2020), in NCHW on cuDNN's convolutions: the
matting net of FFA (``--metric cute``) and of ``--use_mask --matting_weights``.

Counterpart of ``diffsim_tpu/models/u2net.py``: two levels of nested U-structures of RSU blocks
over REBNCONV units (3x3 convolution, inference BatchNorm in float32, ReLU). RSU-L is a small
U-Net of depth L; RSU-4F replaces pooling with dilations 1, 2, 4, 8. Six side outputs are fused
by a 1x1 convolution and a sigmoid; d0, the fused map, is the saliency.

Resampling matches JAX's: the 2x2 stride-2 "SAME" max pool is ``ceil_mode=True`` (the high side
padded on odd sizes), and ``jax.image.resize``'s bilinear upsampling is ``F.interpolate(mode=
"bilinear", align_corners=False)``. On the card PyTorch's defaults hold (cuDNN may use TF32 for
the float32 convolutions).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class U2NetConfig:
    # per encoder stage: (rsu_height or 0 for RSU-4F, in_ch, mid_ch, out_ch)
    encoder: tuple = ()
    # per decoder stage (stage5d .. stage1d): the same layout
    decoder: tuple = ()
    side_channels: tuple = ()  # input channels of side1 .. side6

    @staticmethod
    def u2netp() -> "U2NetConfig":
        return U2NetConfig(
            encoder=((7, 3, 16, 64), (6, 64, 16, 64), (5, 64, 16, 64),
                     (4, 64, 16, 64), (0, 64, 16, 64), (0, 64, 16, 64)),
            decoder=((0, 128, 16, 64), (4, 128, 16, 64), (5, 128, 16, 64),
                     (6, 128, 16, 64), (7, 128, 16, 64)),
            side_channels=(64, 64, 64, 64, 64, 64),
        )

    @staticmethod
    def u2net() -> "U2NetConfig":
        return U2NetConfig(
            encoder=((7, 3, 32, 64), (6, 64, 32, 128), (5, 128, 64, 256),
                     (4, 256, 128, 512), (0, 512, 256, 512), (0, 512, 256, 512)),
            decoder=((0, 1024, 256, 512), (4, 1024, 128, 256), (5, 512, 64, 128),
                     (6, 256, 32, 64), (7, 128, 16, 64)),
            side_channels=(64, 64, 128, 256, 512, 512),
        )

    @staticmethod
    def tiny() -> "U2NetConfig":
        """CPU-test scale: shallow RSUs, few channels."""
        return U2NetConfig(
            encoder=((4, 3, 4, 8), (4, 8, 4, 8), (4, 8, 4, 8),
                     (4, 8, 4, 8), (0, 8, 4, 8), (0, 8, 4, 8)),
            decoder=((0, 16, 4, 8), (4, 16, 4, 8), (4, 16, 4, 8),
                     (4, 16, 4, 8), (4, 16, 4, 8)),
            side_channels=(8, 8, 8, 8, 8, 8),
        )


class _BatchNorm(nn.Module):
    """Inference BatchNorm with the JAX tree's leaves: ``weight`` (scale), ``bias``, ``mean``,
    ``var``; eps 1e-5, computed in float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, y):
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.var.float() + 1e-5).reshape(shape)
        return ((y.float() - self.mean.float().reshape(shape)) * inv
                * self.weight.float().reshape(shape) + self.bias.float().reshape(shape))


class _REBNConv(nn.Module):
    """3x3 convolution (dilation d, "SAME") -> inference BatchNorm -> ReLU."""

    def __init__(self, cin: int, cout: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x))).to(x.dtype)


def _maxpool2(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_to(x, ref):
    """Bilinear resize to ``ref``'s spatial size (align_corners=False)."""
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear", align_corners=False)


class _RSU(nn.Module):
    """RSU-``height``, or RSU-4F when height == 0."""

    def __init__(self, height: int, cin: int, mid: int, cout: int):
        super().__init__()
        self.height = height
        self.rebnconvin = _REBNConv(cin, cout)
        if height == 0:
            self.rebnconv1 = _REBNConv(cout, mid, 1)
            for i, d in ((2, 2), (3, 4), (4, 8)):
                setattr(self, f"rebnconv{i}", _REBNConv(mid, mid, d))
            for i, d in ((3, 4), (2, 2)):
                setattr(self, f"rebnconv{i}d", _REBNConv(2 * mid, mid, d))
            self.rebnconv1d = _REBNConv(2 * mid, cout, 1)
            return
        self.rebnconv1 = _REBNConv(cout, mid)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", _REBNConv(mid, mid))
        setattr(self, f"rebnconv{height}", _REBNConv(mid, mid, 2))  # the bottom, dilation 2
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", _REBNConv(2 * mid, mid))
        self.rebnconv1d = _REBNConv(2 * mid, cout)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        if self.height == 0:
            hx1 = self.rebnconv1(hxin)
            hx2 = self.rebnconv2(hx1)
            hx3 = self.rebnconv3(hx2)
            hx4 = self.rebnconv4(hx3)
            hx3d = self.rebnconv3d(torch.cat([hx4, hx3], 1))
            hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], 1))
            return self.rebnconv1d(torch.cat([hx2d, hx1], 1)) + hxin
        enc, h = [], hxin
        for i in range(1, self.height):  # rebnconv1 .. height-1, pooling between them
            h = getattr(self, f"rebnconv{i}")(h)
            enc.append(h)
            if i < self.height - 1:
                h = _maxpool2(h)
        h = getattr(self, f"rebnconv{self.height}")(enc[-1])
        for i in range(self.height - 1, 0, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, enc[i - 1]], 1))
            if i > 1:
                h = _up_to(h, enc[i - 2])
        return h + hxin


class U2Net(nn.Module):
    def __init__(self, cfg: U2NetConfig):
        super().__init__()
        self.cfg = cfg
        for i, stage in enumerate(cfg.encoder, start=1):
            setattr(self, f"stage{i}", _RSU(*stage))
        for i, stage in zip(range(5, 0, -1), cfg.decoder):
            setattr(self, f"stage{i}d", _RSU(*stage))
        for i, cin in enumerate(cfg.side_channels, start=1):
            setattr(self, f"side{i}", nn.Conv2d(cin, 1, 3, padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W) normalised pixels -> the fused saliency map d0 (B, H, W) in (0, 1),
        float32."""
        hx1 = self.stage1(x)
        hx2 = self.stage2(_maxpool2(hx1))
        hx3 = self.stage3(_maxpool2(hx2))
        hx4 = self.stage4(_maxpool2(hx3))
        hx5 = self.stage5(_maxpool2(hx4))
        hx6 = self.stage6(_maxpool2(hx5))
        hx5d = self.stage5d(torch.cat([_up_to(hx6, hx5), hx5], 1))
        hx4d = self.stage4d(torch.cat([_up_to(hx5d, hx4), hx4], 1))
        hx3d = self.stage3d(torch.cat([_up_to(hx4d, hx3), hx3], 1))
        hx2d = self.stage2d(torch.cat([_up_to(hx3d, hx2), hx2], 1))
        hx1d = self.stage1d(torch.cat([_up_to(hx2d, hx1), hx1], 1))
        sides = [_up_to(getattr(self, f"side{i}")(h), x)
                 for i, h in enumerate((hx1d, hx2d, hx3d, hx4d, hx5d, hx6), start=1)]
        d0 = self.outconv(torch.cat(sides, 1))
        return torch.sigmoid(d0[:, 0].float())
