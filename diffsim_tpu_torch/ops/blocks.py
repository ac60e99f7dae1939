"""Shared neural-net blocks of the SD-1.5 and SDXL models, as torch modules (NCHW inside).

Counterpart of ``diffsim_tpu/ops/blocks.py``. Parameter names follow the JAX parameter tree
(``to_q``, ``norm1``, ``proj_in``, ...), with torch's leaf names (``weight``/``bias``), so the
weight bridge (``convert/bridge.py``) maps one onto the other by rule. Normalisations compute in
float32 and cast back, whatever the activation dtype.

Modules are built on the ``meta`` device and then either loaded from a bridged JAX tree or
randomly initialised on the target device (``metrics/scorer_base.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffsim_tpu_torch.ops.attention import merge_heads, sdpa, split_heads
from diffsim_tpu_torch.ops.kernels import routes
from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff
from diffsim_tpu_torch.ops.taps import IP_QKV, OUTPUT, QKV

# ---------------------------------------------------------------------------
# elementary layers
# ---------------------------------------------------------------------------


def silu(x):
    return F.silu(x)


def gelu(x):
    return F.gelu(x)  # exact erf


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def group_norm(x, weight, bias, groups: int = 32, eps: float = 1e-6):
    """GroupNorm over the channel axis of NCHW with f32 statistics, in the JAX package's
    single-read form: E[x] and E[x^2] over each group, var = max(E[x^2] - E[x]^2, 0)."""
    b, c = x.shape[:2]
    xg = x.reshape(b, groups, -1).float()
    mean = xg.mean(dim=-1, keepdim=True)
    mean2 = (xg * xg).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    return y.to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, eps: float, groups: int = 32):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in f32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    """3x3 conv with SAME padding (stride 1)."""
    return nn.Conv2d(cin, cout, 3, padding=1)


def conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1)


class Downsample(nn.Conv2d):
    """3x3 stride-2 conv. The VAE encoder pads (0, 1) x (0, 1); the UNet pads symmetrically."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__(channels, channels, 3, stride=2, padding=0 if asymmetric_pad else 1)
        self.asymmetric_pad = asymmetric_pad

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return super().forward(x)


class Upsample(nn.Conv2d):
    """Nearest-neighbour 2x followed by a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, padding=1)

    def forward(self, x):
        return super().forward(F.interpolate(x, scale_factor=2.0, mode="nearest"))


# ---------------------------------------------------------------------------
# timestep embedding
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos-first (flip_sin_to_cos, freq shift 0). ``t`` is (B,);
    returns (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimeMLP(nn.Module):
    def __init__(self, din: int, dmid: int):
        super().__init__()
        self.fc1 = nn.Linear(din, dmid)
        self.fc2 = nn.Linear(dmid, dmid)

    def forward(self, emb):
        return self.fc2(silu(self.fc1(emb)))


# ---------------------------------------------------------------------------
# attention with taps
# ---------------------------------------------------------------------------


class IPProjection(nn.Module):
    """One IP-Adapter's image key and value projections at one attn2 site."""

    def __init__(self, cross_dim: int, dim: int):
        super().__init__()
        self.to_k_ip = nn.Linear(cross_dim, dim, bias=False)
        self.to_v_ip = nn.Linear(cross_dim, dim, bias=False)


class Attention(nn.Module):
    """Multi-head attention; ``forward`` returns ``(out, taps)``.

    ``capture`` is None or one of taps.QKV / OUTPUT / IP_QKV. With ``stop`` the module returns
    ``(None, taps)`` as soon as its capture is complete: after the projections for QKV, after
    the adapters' projections for IP_QKV; OUTPUT captures the post-out-proj hidden state.

    ``ip`` holds the IP-Adapter projections of an attn2 site (one :class:`IPProjection` per
    adapter, attached by ``models/ip_adapter.insert_ip_into_unet``). Given per-adapter image
    tokens ``ip_embeds`` (B, T, cross_dim), the output is
    attn(text) + sum_i ip_scale[i] * attn_i(image_i), as in ``diffsim_tpu/ops/blocks.py``."""

    def __init__(self, dim: int, heads: int, context_dim: int | None = None):
        super().__init__()
        cdim = context_dim or dim
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(cdim, dim, bias=False)
        self.to_v = nn.Linear(cdim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)
        self.ip: nn.ModuleList | None = None

    def forward(self, x, context=None, *, capture=None, stop: bool = False, ip_embeds=None,
                ip_scale=None):
        ctx = x if context is None else context
        q = split_heads(self.to_q(x), self.heads)
        k = split_heads(self.to_k(ctx), self.heads)
        v = split_heads(self.to_v(ctx), self.heads)
        taps = {}
        if capture == QKV:
            taps = {"q": q, "k": k, "v": v}
            if stop:
                return None, taps
        ip = []
        if ip_embeds is not None and self.ip is not None:
            ip = [(split_heads(p.to_k_ip(e), self.heads), split_heads(p.to_v_ip(e), self.heads))
                  for p, e in zip(self.ip, ip_embeds)]
        if capture == IP_QKV:
            if not ip:
                raise ValueError("an IP_QKV tap needs an attn2 site with IP-Adapter "
                                 "projections and ip_embeds")
            taps = {"q": q, "ip_k": [k_ for k_, _ in ip], "ip_v": [v_ for _, v_ in ip]}
            if stop:
                return None, taps
        hidden = sdpa(q, k, v)
        for i, (k_ip, v_ip) in enumerate(ip):
            scale = 1.0 if ip_scale is None else ip_scale[i]
            hidden = hidden + scale * sdpa(q, k_ip, v_ip)
        out = self.to_out(merge_heads(hidden))
        if capture == OUTPUT:
            taps = {"out": out}
        return out, taps


# ---------------------------------------------------------------------------
# feed-forward (GEGLU, the SD transformer FF)
# ---------------------------------------------------------------------------


class GEGLUFeedForward(nn.Module):
    """(h * gelu(g)) @ W2 + b2 with [h, g] = x @ W1 + b1, hidden width 4 * dim. Token batches
    that the JAX package routes to its fused kernel run K2 (``ops/kernels/ff.py``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj_in = nn.Linear(dim, dim * 8)
        self.proj_out = nn.Linear(dim * 4, dim)

    def forward(self, x):
        if x.dim() == 3:
            b, s, c = x.shape
            if routes.use_fused_ff(b * s, c, self.proj_in.out_features):
                out = fused_geglu_ff(x.reshape(b * s, c).contiguous(), self.proj_in.weight,
                                     self.proj_in.bias, self.proj_out.weight, self.proj_out.bias)
                return out.reshape(b, s, c)
        h, g = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * gelu(g))


# ---------------------------------------------------------------------------
# SD transformer block / spatial transformer
# ---------------------------------------------------------------------------


class BasicTransformerBlock(nn.Module):
    """attn1 (self) -> attn2 (cross, text) -> GEGLU ff, pre-LN residuals."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context, *, tap=None, stop: bool = False, ip_embeds=None,
                ip_scale=None):
        """``tap`` is None or {'attn': 'attn1'|'attn2', 'capture': ...}. With ``stop`` the
        block returns ``(None, taps)`` as soon as its tap site has captured. ``ip_embeds`` and
        ``ip_scale`` go to attn2 (the IP-Adapter's image cross-attention)."""
        cap1 = tap["capture"] if (tap and tap["attn"] == "attn1") else None
        h, t1 = self.attn1(self.norm1(x), None, capture=cap1, stop=stop)
        if t1 and stop:
            return None, t1
        x = x + h
        cap2 = tap["capture"] if (tap and tap["attn"] == "attn2") else None
        h, t2 = self.attn2(self.norm2(x), context, capture=cap2, stop=stop,
                           ip_embeds=ip_embeds, ip_scale=ip_scale)
        if t2 and stop:
            return None, t2
        x = x + h
        x = x + self.ff(self.norm3(x))
        return x, {**t1, **t2}


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GN(32, eps 1e-6) -> proj_in -> tokens -> blocks -> proj_out -> +res.
    SD-1.5 projects with 1x1 convolutions; SDXL (``linear_proj=True``) with nn.Linear on the
    tokens."""

    def __init__(self, channels: int, heads: int, context_dim: int, depth: int = 1,
                 linear_proj: bool = False):
        super().__init__()
        self.linear_proj = linear_proj
        proj = nn.Linear if linear_proj else conv1x1
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = proj(channels, channels)
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, context_dim) for _ in range(depth))
        self.proj_out = proj(channels, channels)

    def forward(self, x, context, *, tap=None, stop: bool = False, ip_embeds=None,
                ip_scale=None):
        """``tap`` is None or {'tblock': int, 'attn': str, 'capture': str}; negative tblock
        indices count from the end."""
        b, c, hgt, wid = x.shape
        res = x
        h = self.norm(x)
        if self.linear_proj:
            h = self.proj_in(h.flatten(2).transpose(1, 2))
        else:
            h = self.proj_in(h).flatten(2).transpose(1, 2)
        taps = {}
        n = len(self.blocks)
        for i, blk in enumerate(self.blocks):
            block_tap = tap if (tap is not None and tap["tblock"] % n == i) else None
            h, t = blk(h, context, tap=block_tap, stop=stop, ip_embeds=ip_embeds,
                       ip_scale=ip_scale)
            taps.update(t)
            if t and stop:
                return None, taps
        if self.linear_proj:
            h = self.proj_out(h)
        h = h.transpose(1, 2).reshape(b, c, hgt, wid)
        if not self.linear_proj:
            h = self.proj_out(h)
        return h + res, taps


# ---------------------------------------------------------------------------
# resnet block
# ---------------------------------------------------------------------------


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D: GN-silu-conv, +time bias, GN-silu-conv, +shortcut.
    VAE resnets use eps 1e-6 and no temb; UNet resnets take temb and eps 1e-5."""

    def __init__(self, cin: int, cout: int, temb_dim: int | None = None, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(cin, eps)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GroupNorm(cout, eps)
        self.conv2 = conv3x3(cout, cout)
        self.time_emb_proj = nn.Linear(temb_dim, cout) if temb_dim is not None else None
        self.shortcut = conv1x1(cin, cout) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(silu(temb))[:, :, None, None].to(h.dtype)
        h = self.conv2(silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h
