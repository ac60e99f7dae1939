"""CLIP vision tower (ViT-B/32: the CLIP metrics; ViT-H/14: the IP-Adapter's image encoder), on
the math path (50 or 257 tokens: no attention kernel's route).

Counterpart of ``diffsim_tpu/models/clip_vision.py``. Pixels are NCHW, CLIP-normalised. The
patch embedding is a bias-free dense layer over (ph, pw, C)-ordered patches, the JAX layout.

The taps of the CLIP metrics keep the reference hooks' semantics:

* ``capture='qkv'`` projects Q/K/V from the tap layer's *raw input*, before ``norm1`` (the
  reference hook's quirk), not the layer's real post-LayerNorm Q/K/V;
* ``capture='output'`` is the layer's output hidden state.

XLA drops what a jitted graph does not return; eager PyTorch does not, so :meth:`CLIPVision.tap`
runs the layers up to the tap and returns, and :meth:`CLIPVision.penultimate` (what the
IP-Adapter reads) returns before the last layer.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from diffsim_tpu_torch.ops.attention import merge_heads, sdpa, split_heads
from diffsim_tpu_torch.ops.blocks import LayerNorm, quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    patch: int = 32
    image_size: int = 224
    projection_dim: int = 512
    eps: float = 1e-5

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1

    @staticmethod
    def b32() -> "CLIPVisionConfig":
        return CLIPVisionConfig()

    @staticmethod
    def h14() -> "CLIPVisionConfig":
        """CLIP ViT-H/14, the IP-Adapter(-plus) image encoder."""
        return CLIPVisionConfig(hidden=1280, layers=32, heads=16, intermediate=5120,
                                patch=14, image_size=224, projection_dim=1024)

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(hidden=32, layers=2, heads=2, intermediate=64, patch=8,
                                image_size=32, projection_dim=16)


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(hidden, hidden)
        self.k = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def qkv(self, x):
        return tuple(split_heads(proj(x), self.heads) for proj in (self.q, self.k, self.v))

    def forward(self, x):
        return self.out(merge_heads(sdpa(*self.qkv(x))))


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.hidden, cfg.eps)
        self.attn = _Attention(cfg.hidden, cfg.heads)
        self.norm2 = LayerNorm(cfg.hidden, cfg.eps)
        self.fc1 = nn.Linear(cfg.hidden, cfg.intermediate)
        self.fc2 = nn.Linear(cfg.intermediate, cfg.hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(quick_gelu(self.fc1(self.norm2(x))))


class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden))
        self.patch_embedding = nn.Linear(cfg.patch * cfg.patch * 3, cfg.hidden, bias=False)
        self.position_embedding = nn.Parameter(torch.empty(cfg.tokens, cfg.hidden))
        self.pre_norm = LayerNorm(cfg.hidden, cfg.eps)
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.layers))
        self.post_norm = LayerNorm(cfg.hidden, cfg.eps)
        self.visual_projection = nn.Linear(cfg.hidden, cfg.projection_dim, bias=False)

    def _embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) -> the pre-LayerNormed tokens (B, 1 + (S / patch)^2, hidden)."""
        b, c, h, w = pixels.shape
        p = self.cfg.patch
        patches = pixels.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
        x = self.patch_embedding(patches.reshape(b, (h // p) * (w // p), p * p * c))
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        return self.pre_norm(x)

    def forward(self, pixels: torch.Tensor, *, output_hidden_states: bool = False) -> dict:
        """pixels (B, 3, S, S), CLIP-normalised -> {'last_hidden_state', 'pooled' (the
        post-LayerNormed CLS token), 'image_embeds' (its projection)}, plus 'hidden_states'
        (the embeddings and every layer's output) with ``output_hidden_states``. The taps of
        JAX's ``apply(tap_layer=..., capture=...)`` are :meth:`tap`'s."""
        x = self._embed(pixels)
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x)
            hidden_states.append(x)
        pooled = self.post_norm(x[:, 0])
        out = {"last_hidden_state": x, "pooled": pooled,
               "image_embeds": self.visual_projection(pooled)}
        if output_hidden_states:
            out["hidden_states"] = hidden_states
        return out

    def tap(self, pixels: torch.Tensor, tap_layer: int, capture: str = "qkv") -> dict:
        """The taps of layer ``tap_layer % layers``, running the layers up to it only:
        {'q', 'k', 'v'} (B, heads, tokens, head_dim) projected from the tap layer's input before
        ``norm1``, or {'out'}: the layer's output (B, tokens, hidden)."""
        if capture not in ("qkv", "output"):
            raise ValueError(f"unknown capture: {capture}")
        idx = tap_layer % self.cfg.layers
        x = self._embed(pixels)
        for layer in self.layers[:idx]:
            x = layer(x)
        layer = self.layers[idx]
        return dict(zip("qkv", layer.attn.qkv(x))) if capture == "qkv" else {"out": layer(x)}

    def penultimate(self, pixels: torch.Tensor) -> torch.Tensor:
        """``forward(pixels, output_hidden_states=True)['hidden_states'][-2]``, without running
        the last layer: what the IP-Adapter-plus Resampler reads."""
        x = self._embed(pixels)
        for layer in self.layers[:-1]:
            x = layer(x)
        return x


def out_proj_replay(model: CLIPVision, context: torch.Tensor, tap_layer: int) -> torch.Tensor:
    """The reference's out-projection replay in its attention readout: merge the heads of
    ``context`` (B, heads, S, D), then apply the tap layer's ``out`` projection."""
    layer = model.layers[tap_layer % model.cfg.layers]
    return layer.attn.out(merge_heads(context))
