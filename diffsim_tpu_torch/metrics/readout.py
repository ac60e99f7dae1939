"""The DiffSim cross-image attention readout.

Counterpart of ``diffsim_tpu/metrics/readout.py:cross_attention_score``. Given taps (Q, K, V)
for two images it computes

    sim(attn(Q_A, K_B, V_B), attn(Q_A, K_A, V_A))   and symmetrically for B,

reduced with full-flatten cosine (eps 1e-8) or MSE over everything but the leading pair axis,
and averaged over both directions. Taps are (P, B, heads, seq, head_dim).

Tap shapes that the JAX package routes to its fused readout kernel (K3: S >= 512, S % 512 == 0,
D <= 128: every SDXL tap, the SD-1.5 up-block-2/3 taps) go, both directions, through the port's
K3 ``fused_direction_score`` (``ops/kernels/readout.py``), which never writes the four attention
outputs; on a CPU tensor that is K3's plain version.
"""

from __future__ import annotations

import torch

from diffsim_tpu_torch.ops.attention import sdpa
from diffsim_tpu_torch.ops.kernels import routes
from diffsim_tpu_torch.ops.kernels.readout import fused_direction_score

_COS_EPS = 1e-8


def _flat_cosine(x, y):
    xf = x.reshape(x.shape[0], -1).float()
    yf = y.reshape(y.shape[0], -1).float()
    dot = (xf * yf).sum(dim=-1)
    nx = torch.clamp(torch.linalg.vector_norm(xf, dim=-1), min=_COS_EPS)
    ny = torch.clamp(torch.linalg.vector_norm(yf, dim=-1), min=_COS_EPS)
    return dot / (nx * ny)


def _flat_mse(x, y):
    d = (x.float() - y.float()).reshape(x.shape[0], -1)
    return (d * d).mean(dim=-1)


def cross_attention_score(qa, ka, va, qb, kb, vb, similarity: str = "cosine") -> torch.Tensor:
    """(P,) DiffSim scores from per-image taps of shape (P, B, heads, seq, head_dim)."""
    if similarity not in ("cosine", "mse"):
        raise ValueError(f"unknown similarity: {similarity}")
    if qa.dim() == 5 and qa.shape == kb.shape and routes.use_fused_readout(qa.shape):
        a_on_b = fused_direction_score(qa, ka, va, kb, vb, similarity)
        b_on_a = fused_direction_score(qb, kb, vb, ka, va, similarity)
        return (a_on_b + b_on_a) / 2.0
    attn_a_on_b = sdpa(qa, kb, vb)
    attn_b_on_a = sdpa(qb, ka, va)
    self_attn_a = sdpa(qa, ka, va)
    self_attn_b = sdpa(qb, kb, vb)
    sim = _flat_cosine if similarity == "cosine" else _flat_mse
    return (sim(attn_a_on_b, self_attn_a) + sim(attn_b_on_a, self_attn_b)) / 2.0
