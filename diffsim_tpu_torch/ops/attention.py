"""Scaled-dot-product attention and the (B, heads, S, D) head layout.

The math path keeps the JAX package's numerics (``diffsim_tpu/ops/attention.py:sdpa``): f32
logits and softmax, probabilities cast to V's dtype before PV, f32 accumulation, output in V's
dtype. Square self-attention sites that the JAX package routes to a Pallas kernel route here to
the port's kernel of the same name (``ops/kernels/routes.py``): K1 ``fused_self_attention`` for
the UNet's heads, K4 ``streaming_self_attention`` for the wide single head of a 1024 px VAE.
"""

from __future__ import annotations

import torch

from diffsim_tpu_torch.ops.kernels import routes
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention
from diffsim_tpu_torch.ops.kernels.attention_stream import streaming_self_attention


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (..., heads, seq, head_dim), softmax scale 1/sqrt(head_dim)."""
    scale = q.shape[-1] ** -0.5
    if q.dim() == 4:
        if routes.use_fused(q.shape, k.shape):
            return fused_self_attention(q.contiguous(), k.contiguous(), v.contiguous())
        if routes.use_streaming(q.shape, k.shape):
            return streaming_self_attention(q.contiguous(), k.contiguous(), v.contiguous())
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    weights = torch.softmax(logits * scale, dim=-1)
    out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, heads, S, D)."""
    b, s, hd = x.shape
    return x.view(b, s, heads, hd // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, S, D) -> (B, S, heads*D)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
