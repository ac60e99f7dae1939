"""Shared machinery of the port's scorers: device choice, parameter placement and random
init, and the asynchronous fetch contract of ``diffsim_tpu/metrics/scorer_base.py``."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from diffsim_tpu_torch.convert import bridge
from diffsim_tpu_torch.core import prng
from diffsim_tpu_torch.metrics import readout


def resolve_device(device) -> torch.device:
    """The scoring device: ``cuda`` unless the caller names one. Without a CUDA device and
    without an explicit ``device``, raise: the port never quietly scores on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to score on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def fetchable(scores: torch.Tensor, blocking: bool):
    """``blocking=True`` returns the (N,) float32 scores now; ``blocking=False`` returns a
    zero-arg callable that fetches them, so the caller's host work overlaps the device's."""

    def fetch():
        return scores.float().cpu().numpy()

    return fetch() if blocking else fetch


def fetchable_pair(s_ab: torch.Tensor, s_ac: torch.Tensor, blocking: bool):
    """Triplet-path variant of :func:`fetchable`: one fetch for both (T,) score arrays."""

    def fetch():
        both = torch.stack([s_ab.float(), s_ac.float()]).cpu().numpy()
        return both[0], both[1]

    return fetch() if blocking else fetch


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill a materialised module in place from ``generator`` on the module's device, as the
    JAX ``*_init`` functions do: matrices and embedding tables N(0, 0.02), norm scales one,
    biases zero. One kernel per tensor on the card, so SD-1.5 at full width takes seconds."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.data.zero_()
        elif p.dim() == 1:
            p.data.fill_(1.0)
        else:
            p.data.normal_(0.0, 0.02, generator=generator)
    return module


def build_module(factory: Callable[[], nn.Module], tree, kind: str, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator) -> nn.Module:
    """Build ``factory()`` on the meta device, then fill it on ``device`` in ``dtype`` from the
    JAX tree ``tree`` through the strict bridge, or randomly from ``generator`` when ``tree``
    is None. Returned in eval mode with gradients off."""
    with torch.device("meta"):
        module = factory()
    if tree is None:
        module = init_random_(module.to_empty(device=device).to(dtype), generator)
    else:
        module = bridge.load(module, tree, kind, device, dtype)
    return module.eval().requires_grad_(False)


def to_device_pixels(roles, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """NHWC role arrays (uint8, or float in [-1, 1]; the first role's dtype decides, as in the
    JAX scorer) -> one NCHW batch on ``device``. uint8 maps to [-1, 1] on the device
    (``u8 / 127.5 - 1`` in f32, then cast)."""
    if np.asarray(roles[0]).dtype == np.uint8:
        pix = torch.from_numpy(np.concatenate([np.asarray(r, np.uint8) for r in roles]))
        pix = pix.to(device)
        pix = (pix.float() / 127.5 - 1.0).to(dtype)
    else:
        pix = torch.from_numpy(np.concatenate([np.asarray(r, np.float32) for r in roles]))
        pix = pix.to(device=device, dtype=dtype)
    return pix.permute(0, 3, 1, 2).contiguous()


def role_noise(seed: int, h: int, w: int, channels: int, device: torch.device,
               noise_override=None):
    """(eps_vae, eps_noise), each (2, C, h, w) f32 on ``device``: roles [A, B]. The draws come
    from ``seed`` (``core/prng.py``) unless ``noise_override`` gives them as two NHWC arrays
    (2, h, w, C), the cross-framework parity mode."""
    if noise_override is not None:
        return tuple(torch.as_tensor(np.asarray(e, np.float32), device=device)
                     .permute(0, 3, 1, 2) for e in noise_override)
    vae_a, vae_b, noise_a, noise_b = prng.role_noise(seed, (h, w, channels), device)
    return (torch.stack([vae_a, vae_b]).permute(0, 3, 1, 2),
            torch.stack([noise_a, noise_b]).permute(0, 3, 1, 2))


def pair_score(qkv, sl_a: slice, sl_b: slice, similarity: str) -> torch.Tensor:
    """(P,) scores between the images at rows ``sl_a`` and ``sl_b`` of taps (P, rows, ...)."""
    q, k, v = qkv
    return readout.cross_attention_score(q[:, sl_a], k[:, sl_a], v[:, sl_a],
                                         q[:, sl_b], k[:, sl_b], v[:, sl_b], similarity)
