"""DINOv2 (HF ``Dinov2Model``) and DINO v1 (ViT-S/8) towers with taps, on the math path: the
backbones of the dino / dinov1 / dino_cross / dinofeats baselines and of FFA (``cute``).

Counterpart of ``diffsim_tpu/models/dinov2.py``. Pixels are NCHW, ImageNet-normalised; the patch
embedding is a dense layer over (ph, pw, C)-ordered patches, the JAX layout. Token counts (257 at
224 px, 577 for FFA at 336 px, 785 for ViT-S/8) miss every attention kernel's route, as in JAX.

The taps fire on the self-attention, whose input is post-LayerNorm, so ``capture='qkv'`` gives
the layer's real Q/K/V; ``capture='output'`` gives the merged attention context *before* the
output dense (the reference's hook on the attention submodule).

The stored position grid is resized to the runtime grid by bicubic interpolation as
``jax.image.resize`` does it (Keys a = -0.5, antialiased when it shrinks): that is
``F.interpolate(mode="bicubic", antialias=True)``. HF's ``Dinov2Embeddings`` resizes without
antialiasing, so both packages differ from HF there (ROADMAP, Queue 3).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from diffsim_tpu_torch.ops.attention import merge_heads, sdpa, split_heads
from diffsim_tpu_torch.ops.blocks import LayerNorm, gelu


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    hidden: int = 384
    layers: int = 12
    heads: int = 6
    intermediate: int = 1536
    patch: int = 14
    pos_grid: int = 37  # the stored position grid's side (dinov2-small trains at 518 / 14)
    layerscale: bool = True  # v2 yes, v1 no
    eps: float = 1e-6

    @staticmethod
    def v2_small() -> "DinoConfig":
        return DinoConfig()

    @staticmethod
    def v2_base() -> "DinoConfig":
        return DinoConfig(hidden=768, heads=12, intermediate=3072)

    @staticmethod
    def v1_vits8() -> "DinoConfig":
        """DINO v1 ViT-S/8 (torch.hub dino_vits8): patch 8, trained at 224 px (28 x 28)."""
        return DinoConfig(patch=8, pos_grid=28, layerscale=False)

    @staticmethod
    def tiny(layerscale: bool = True) -> "DinoConfig":
        return DinoConfig(hidden=32, layers=2, heads=2, intermediate=64, patch=8, pos_grid=4,
                          layerscale=layerscale)


class _Attention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.q = nn.Linear(hidden, hidden)
        self.k = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)


class _Layer(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.heads = cfg.heads
        self.norm1 = LayerNorm(cfg.hidden, cfg.eps)
        self.attn = _Attention(cfg.hidden)
        self.norm2 = LayerNorm(cfg.hidden, cfg.eps)
        self.fc1 = nn.Linear(cfg.hidden, cfg.intermediate)
        self.fc2 = nn.Linear(cfg.intermediate, cfg.hidden)
        if cfg.layerscale:
            self.ls1 = nn.Parameter(torch.empty(cfg.hidden))
            self.ls2 = nn.Parameter(torch.empty(cfg.hidden))
        else:
            self.ls1 = self.ls2 = None

    def qkv(self, x):
        h = self.norm1(x)
        a = self.attn
        return tuple(split_heads(proj(h), self.heads) for proj in (a.q, a.k, a.v))

    def finish(self, x, ctx):
        """The rest of the layer after the attention context ``ctx`` (B, heads, S, D)."""
        attn_out = self.attn.out(merge_heads(ctx))
        if self.ls1 is not None:
            attn_out = attn_out * self.ls1
        x = x + attn_out
        mlp = self.fc2(gelu(self.fc1(self.norm2(x))))
        if self.ls2 is not None:
            mlp = mlp * self.ls2
        return x + mlp

    def forward(self, x):
        return self.finish(x, sdpa(*self.qkv(x)))


def interpolate_pos_embed(pos: torch.Tensor, target_grid: int) -> torch.Tensor:
    """(1 + g^2, C) position table -> (1 + target_grid^2, C): the patch grid resized bicubically
    as ``jax.image.resize`` does (antialiased when it shrinks), the CLS position passed
    through."""
    grid = int(round((pos.shape[0] - 1) ** 0.5))
    if grid == target_grid:
        return pos
    patch = pos[1:].float().reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
    patch = F.interpolate(patch, size=(target_grid, target_grid), mode="bicubic",
                          align_corners=False, antialias=True)
    patch = patch.permute(0, 2, 3, 1).reshape(target_grid * target_grid, -1)
    return torch.cat([pos[:1], patch.to(pos.dtype)])


class Dino(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.empty(cfg.hidden))
        self.patch_embedding = nn.Linear(cfg.patch * cfg.patch * 3, cfg.hidden)
        self.position_embedding = nn.Parameter(torch.empty(cfg.pos_grid ** 2 + 1, cfg.hidden))
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.layers))
        self.final_norm = LayerNorm(cfg.hidden, cfg.eps)

    def _embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) -> tokens (B, 1 + (S / patch)^2, hidden) with their positions."""
        b, c, h, w = pixels.shape
        p = self.cfg.patch
        patches = pixels.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
        x = self.patch_embedding(patches.reshape(b, (h // p) * (w // p), p * p * c))
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
        return x + interpolate_pos_embed(self.position_embedding, h // p)[None]

    def forward(self, pixels: torch.Tensor) -> dict:
        """pixels (B, 3, S, S) -> {'last_hidden_state' (after the final LayerNorm), 'cls' (its
        CLS token)}."""
        x = self._embed(pixels)
        for layer in self.layers:
            x = layer(x)
        x = self.final_norm(x)
        return {"last_hidden_state": x, "cls": x[:, 0]}

    def tap(self, pixels: torch.Tensor, tap_layer: int, capture: str = "qkv") -> dict:
        """The taps of layer ``tap_layer % layers``, running the layers up to it only:
        {'q', 'k', 'v'} (B, heads, tokens, head_dim), or {'out'}: the merged attention context
        before the output dense (B, tokens, hidden)."""
        if capture not in ("qkv", "output"):
            raise ValueError(f"unknown capture: {capture}")
        idx = tap_layer % self.cfg.layers
        x = self._embed(pixels)
        for layer in self.layers[:idx]:
            x = layer(x)
        q, k, v = self.layers[idx].qkv(x)
        if capture == "qkv":
            return {"q": q, "k": k, "v": v}
        return {"out": merge_heads(sdpa(q, k, v))}
