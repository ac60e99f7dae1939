"""The DiffSim cross-image attention readout, and the readouts of its variants.

Counterpart of ``diffsim_tpu/metrics/readout.py``. Given taps (Q, K, V)
for two images it computes

    sim(attn(Q_A, K_B, V_B), attn(Q_A, K_A, V_A))   and symmetrically for B,

reduced with full-flatten cosine (eps 1e-8) or MSE over everything but the leading pair axis,
and averaged over both directions. Taps are (P, B, heads, seq, head_dim).

Tap shapes that the JAX package routes to its fused readout kernel (K3: S >= 512, S % 512 == 0,
D <= 128: every SDXL tap, the SD-1.5 up-block-2/3 taps) go, both directions, through the port's
K3 ``fused_direction_score`` (``ops/kernels/readout.py``), which never writes the four attention
outputs; on a CPU tensor that is K3's plain version.

:func:`cross_attention_score_ip` reads the IP-Adapter taps (per-adapter K/V lists, never square,
so never K3), :func:`mask_to_latent` turns pixel masks into per-token query weights, and
:func:`feature_score` is the ``diffeats`` readout of the attention outputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffsim_tpu_torch.ops.attention import sdpa
from diffsim_tpu_torch.ops.kernels import routes
from diffsim_tpu_torch.ops.kernels.readout import fused_direction_score

_COS_EPS = 1e-8


# The flat reductions accumulate in float64 and return float32. A float32 sum over a tap's
# 10^5-10^6 elements carries an error that depends on the device's summation order, and at a
# 4096-token IP-Adapter tap it splits the card's and the CPU's scores beyond chip_smoke.py's
# card-vs-CPU limits (tests/test_torch_port_ip.py holds the reductions to their float64 value).


def _flat_cosine(x, y):
    xf = x.reshape(x.shape[0], -1).double()
    yf = y.reshape(y.shape[0], -1).double()
    dot = (xf * yf).sum(dim=-1)
    nx = torch.clamp(torch.linalg.vector_norm(xf, dim=-1), min=_COS_EPS)
    ny = torch.clamp(torch.linalg.vector_norm(yf, dim=-1), min=_COS_EPS)
    return (dot / (nx * ny)).float()


def _flat_mse(x, y):
    d = (x.double() - y.double()).reshape(x.shape[0], -1)
    return (d * d).mean(dim=-1).float()


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


def cross_attention_score_ip(qa, ip_ka, ip_va, qb, ip_kb, ip_vb,
                             similarity: str = "cosine") -> torch.Tensor:
    """The IP-Adapter readout: K/V are per-adapter lists; the adapters' scores are averaged
    (cosine) or summed (mse: the reference's list-sum path made to work, quirk Q4)."""
    per_adapter = torch.stack([
        cross_attention_score(qa, ka, va, qb, kb, vb, similarity)
        for ka, va, kb, vb in zip(ip_ka, ip_va, ip_kb, ip_vb)])
    return per_adapter.mean(dim=0) if similarity == "cosine" else per_adapter.sum(dim=0)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size) in float32, bilinear with half-pixel centres and, when
    it shrinks, a triangle filter widened by the scale: ``jax.image.resize(..., "bilinear")``,
    which antialiases (PyTorch's default bilinear does not)."""
    return F.interpolate(x.float(), size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


def mask_to_latent(mask: torch.Tensor, latent_side: int) -> torch.Tensor:
    """Pixel-space foreground masks (..., H, W) in [0, 1] -> per-token query weights
    (..., latent_side^2): a 5x5 max-pool dilation with SAME padding, then
    :func:`resize_bilinear` to the latent grid."""
    lead = mask.shape[:-2]
    m = F.max_pool2d(mask.reshape((-1, 1) + mask.shape[-2:]).float(), 5, stride=1, padding=2)
    return resize_bilinear(m, latent_side).reshape(lead + (latent_side * latent_side,))


def feature_score(fa, fb, similarity: str = "cosine",
                  minmax_normalize: bool = False) -> torch.Tensor:
    """The ``diffeats`` readout of attention outputs (P, ...): an optional per-tensor min-max
    normalisation, then the flat cosine or MSE."""
    if minmax_normalize:
        def _norm(x):
            xf = x.reshape(x.shape[0], -1).float()
            lo = xf.amin(dim=-1, keepdim=True)
            hi = xf.amax(dim=-1, keepdim=True)
            return (xf - lo) / (hi - lo + 1e-12)

        fa, fb = _norm(fa), _norm(fb)
    return _flat_cosine(fa, fb) if similarity == "cosine" else _flat_mse(fa, fb)
