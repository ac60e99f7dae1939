"""AutoencoderKL (the Stable Diffusion VAE), NCHW inside.

Counterpart of ``diffsim_tpu/models/vae.py``: the encoder, which the scorers and the DiT trainer
run, and the decoder, which the DiT sampler runs. The mid attention is single-head at d = the
last block's width (512 in ``sd()`` and ``sdxl()``); at up to 4096 tokens (512 px) it takes the
math path, as in the JAX package; at >= 8192 tokens (1024 px, the SDXL path) it runs the K4
streaming kernel (``ops/kernels/attention_stream.py``), which takes d up to 1024.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from diffsim_tpu_torch.ops.attention import sdpa
from diffsim_tpu_torch.ops.blocks import (
    Downsample,
    GroupNorm,
    ResnetBlock,
    Upsample,
    conv1x1,
    conv3x3,
    silu,
)
from diffsim_tpu_torch.runtime.profiling import span


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    in_channels: int = 3
    latent_channels: int = 4
    scaling_factor: float = 0.18215

    @staticmethod
    def sd() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def sdxl() -> "VAEConfig":
        return VAEConfig(scaling_factor=0.13025)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(32, 64), layers_per_block=1, scaling_factor=0.18215)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class AttnBlock(nn.Module):
    """Single-head self-attention with qkv bias and a residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2)  # (B, S, C)
        q = self.to_q(y)[:, None]  # single head: (B, 1, S, C)
        k = self.to_k(y)[:, None]
        v = self.to_v(y)[:, None]
        y = self.to_out(sdpa(q, k, v)[:, 0])
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnet1 = ResnetBlock(channels, channels)
        self.attn = AttnBlock(channels)
        self.resnet2 = ResnetBlock(channels, channels)

    def forward(self, x):
        return self.resnet2(self.attn(self.resnet1(x)))


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout) for j in range(layers))
        self.downsample = Downsample(cout, asymmetric_pad=True) if downsample else None

    def forward(self, x):
        for rn in self.resnets:
            x = rn(x)
        return x if self.downsample is None else self.downsample(x)


class Encoder(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> moments (B, 2*latent, H/8, W/8)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = conv3x3(cfg.in_channels, chans[0])
        cins = (chans[0],) + tuple(chans[:-1])
        self.down = nn.ModuleList(
            _Down(cin, cout, cfg.layers_per_block, i < len(chans) - 1)
            for i, (cin, cout) in enumerate(zip(cins, chans)))
        self.mid = _Mid(chans[-1])
        self.norm_out = GroupNorm(chans[-1], eps=1e-6)
        self.conv_out = conv3x3(chans[-1], 2 * cfg.latent_channels)
        self.quant_conv = conv1x1(2 * cfg.latent_channels, 2 * cfg.latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down:
            h = blk(h)
        h = self.mid(h)
        h = self.conv_out(silu(self.norm_out(h)))
        return self.quant_conv(h)


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout) for j in range(layers))
        self.upsample = Upsample(cout) if upsample else None

    def forward(self, x):
        for rn in self.resnets:
            x = rn(x)
        return x if self.upsample is None else self.upsample(x)


class Decoder(nn.Module):
    """Latents already divided by the scaling factor, (B, latent, h, w) -> an image
    (B, 3, 8h, 8w) in about [-1, 1]: ``post_quant_conv``, ``conv_in``, the mid block, the up
    blocks (``layers_per_block + 1`` resnets each, all but the last followed by a nearest-2x
    upsample and a 3x3 conv), ``norm_out``, ``conv_out``; ``decoder_init`` / ``decoder_apply``
    of the JAX package."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = tuple(reversed(cfg.block_out_channels))
        self.post_quant_conv = conv1x1(cfg.latent_channels, cfg.latent_channels)
        self.conv_in = conv3x3(cfg.latent_channels, rev[0])
        self.mid = _Mid(rev[0])
        cins = (rev[0],) + rev[:-1]
        self.up = nn.ModuleList(
            _Up(cin, cout, cfg.layers_per_block + 1, i < len(rev) - 1)
            for i, (cin, cout) in enumerate(zip(cins, rev)))
        self.norm_out = GroupNorm(rev[-1], eps=1e-6)
        self.conv_out = conv3x3(rev[-1], cfg.in_channels)

    def forward(self, z):
        h = self.mid(self.conv_in(self.post_quant_conv(z)))
        for blk in self.up:
            h = blk(h)
        return self.conv_out(silu(self.norm_out(h)))


def default_chunk(x: torch.Tensor) -> int:
    """The JAX package's default encode chunk: 16 images at 512 px in bf16, so 2 at 1024 px in
    f32 (the input pixels of a slice are held at 8 MiB). The formula is a TPU memory
    calibration, kept for parity of the chunking."""
    budget = 16 * 512 * 512 * 2
    return max(1, budget // (x.shape[-2] * x.shape[-1] * x.element_size()))


def encode_chunked(encoder: Encoder, x: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """``encoder`` over (B, 3, H, W) in slices of ``chunk`` images (default
    :func:`default_chunk`), a Python loop standing in for the JAX package's
    ``encoder_apply_chunked`` (``lax.map`` plus one remainder slice). Slicing bounds the
    full-resolution activations, the largest live buffers of the scoring graph."""
    chunk = chunk or default_chunk(x)
    with span("vae"):
        return torch.cat([encoder(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)])


def sample_latents(moments, scaling_factor: float, noise=None, mode: bool = False):
    """DiagonalGaussianDistribution.sample() * scaling_factor over the channel axis (-3) of
    NCHW moments: logvar clamped to [-30, 20], f32 noise, the sum cast back to the moments'
    dtype before scaling. ``mode=True`` returns the posterior mean."""
    mean, logvar = moments.chunk(2, dim=-3)
    if mode:
        return mean * scaling_factor
    std = torch.exp(0.5 * torch.clamp(logvar.float(), -30.0, 20.0))
    return (mean.float() + std * noise).to(mean.dtype) * scaling_factor
