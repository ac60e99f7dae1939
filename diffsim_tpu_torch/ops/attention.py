"""Scaled-dot-product attention and the (B, heads, S, D) head layout.

The math path keeps the JAX package's numerics (``diffsim_tpu/ops/attention.py:sdpa``): f32
logits and softmax, probabilities cast to V's dtype before PV, f32 accumulation, output in V's
dtype. Square self-attention sites that the JAX package routes to a Pallas kernel route here to
the port's kernel of the same name (``ops/kernels/routes.py``): K1 ``fused_self_attention`` for
the UNet's heads, K4 ``streaming_self_attention`` for the wide single head of a 1024 px VAE.

:func:`fast_softmax` is the ``--bf16_softmax`` mode of ``diffsim_tpu/ops/attention.py``: inside
it, every ``sdpa`` call takes bf16 probabilities (the kernels' ``bf16_probs`` mode, and the math
path's bf16 softmax). PyTorch runs eagerly, so the flag is read when the call is made, which is
when the JAX package reads it while tracing.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from diffsim_tpu_torch.ops.kernels import routes
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention, round_bf16
from diffsim_tpu_torch.ops.kernels.attention_stream import streaming_self_attention

_FAST_SOFTMAX: contextvars.ContextVar = contextvars.ContextVar("fast_softmax", default=False)


@contextlib.contextmanager
def fast_softmax(enabled: bool = True):
    """Within the block, attention probabilities are computed in bf16 (``enabled=False`` is a
    no-op). Not parity with the float32 softmax of the exact mode."""
    if not enabled:
        yield
        return
    token = _FAST_SOFTMAX.set(True)
    try:
        yield
    finally:
        _FAST_SOFTMAX.reset(token)


def fast_softmax_enabled() -> bool:
    return _FAST_SOFTMAX.get()


def _fast_weights(logits: torch.Tensor, scale: float) -> torch.Tensor:
    """The JAX math path's fast softmax (the centred logits rounded to bf16, then
    ``jax.nn.softmax(logits * scale)`` in bf16) as XLA's CPU compiler computes it: the product
    with the bf16-rounded scale rounded to bf16, the exponentials of (x - max x) rounded to bf16
    in float32, their float32 sum rounded to bf16, and the quotient left in float32 until the
    cast to V's dtype. Normalised before P V, unlike the kernels."""
    scale_bf16 = round_bf16(torch.tensor(scale)).item()
    x = round_bf16(round_bf16(logits - logits.amax(dim=-1, keepdim=True)) * scale_bf16)
    u = torch.exp(round_bf16(x - x.amax(dim=-1, keepdim=True)))
    return round_bf16(u) / round_bf16(u.sum(dim=-1, keepdim=True))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (..., heads, seq, head_dim), softmax scale 1/sqrt(head_dim); inside
    :func:`fast_softmax` with bf16 probabilities."""
    scale = q.shape[-1] ** -0.5
    fast = fast_softmax_enabled()
    if q.dim() == 4:
        if routes.use_fused(q.shape, k.shape):
            return fused_self_attention(q.contiguous(), k.contiguous(), v.contiguous(), fast)
        if routes.use_streaming(q.shape, k.shape):
            return streaming_self_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                            fast)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if fast:
        weights = _fast_weights(logits, scale)
    else:
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
