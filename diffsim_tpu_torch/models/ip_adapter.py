"""IP-Adapter image-projection heads and their wiring into the UNet.

Counterpart of ``diffsim_tpu/models/ip_adapter.py``. Two published heads:

* :class:`ImageProjection` (plain ip-adapter): the CLIP image embedding -> ``num_tokens``
  tokens of the UNet's cross dim, then a LayerNorm;
* :class:`Resampler` (ip-adapter-plus): learned latent queries attend, Perceiver-style, over
  ``concat(x, latents)`` of the CLIP-H penultimate patch tokens, ``depth`` times, giving 16
  tokens. Its attention is its own einsum softmax (float32 logits, the probabilities cast to
  V's dtype), as in the JAX package.

The adapters' key and value projections live in each attn2 (``ops/blocks.Attention.ip``):
:func:`insert_ip_into_unet` places them in the published traversal order,
:func:`attn2_site_order`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from diffsim_tpu_torch.ops.attention import merge_heads, split_heads
from diffsim_tpu_torch.ops.blocks import LayerNorm, gelu


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 768  # query / latent width (the SD-1.5 cross dim for sd15-plus)
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280  # CLIP-H hidden
    output_dim: int = 768
    ff_mult: int = 4

    @staticmethod
    def sd15_plus() -> "ResamplerConfig":
        return ResamplerConfig()

    @staticmethod
    def sdxl_plus() -> "ResamplerConfig":
        return ResamplerConfig(dim=1280, heads=20, output_dim=2048)

    @staticmethod
    def tiny() -> "ResamplerConfig":
        return ResamplerConfig(dim=16, depth=2, dim_head=8, heads=2, num_queries=4,
                               embedding_dim=32, output_dim=32, ff_mult=2)


class _PerceiverLayer(nn.Module):
    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        inner = cfg.dim_head * cfg.heads
        self.heads, self.scale = cfg.heads, cfg.dim_head ** -0.5
        self.norm1 = LayerNorm(cfg.dim)  # over x
        self.norm2 = LayerNorm(cfg.dim)  # over the latents
        self.to_q = nn.Linear(cfg.dim, inner, bias=False)
        self.to_kv = nn.Linear(cfg.dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, cfg.dim, bias=False)
        self.ff_norm = LayerNorm(cfg.dim)
        self.ff1 = nn.Linear(cfg.dim, cfg.dim * cfg.ff_mult, bias=False)
        self.ff2 = nn.Linear(cfg.dim * cfg.ff_mult, cfg.dim, bias=False)

    def forward(self, x, latents):
        ln = self.norm2(latents)
        q = split_heads(self.to_q(ln), self.heads)
        k, v = (split_heads(t, self.heads)
                for t in self.to_kv(torch.cat([self.norm1(x), ln], dim=1)).chunk(2, dim=-1))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float()).to(v.dtype)
        latents = latents + self.to_out(merge_heads(out))
        return latents + self.ff2(gelu(self.ff1(self.ff_norm(latents))))


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        self.cfg = cfg
        self.latents = nn.Parameter(torch.empty(cfg.num_queries, cfg.dim))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim)
        self.norm_out = LayerNorm(cfg.output_dim)
        self.layers = nn.ModuleList(_PerceiverLayer(cfg) for _ in range(cfg.depth))

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        """(B, S, embedding_dim), the CLIP-H penultimate hidden states -> (B, num_queries,
        output_dim)."""
        x = self.proj_in(image_embeds)
        latents = self.latents.expand(image_embeds.shape[0], -1, -1)
        for layer in self.layers:
            latents = layer(x, latents)
        return self.norm_out(self.proj_out(latents))


class ImageProjection(nn.Module):
    """The plain ip-adapter head: (B, image_embed_dim) -> (B, num_tokens, cross_dim)."""

    def __init__(self, image_embed_dim: int = 1024, cross_dim: int = 768, num_tokens: int = 4):
        super().__init__()
        self.num_tokens = num_tokens
        self.proj = nn.Linear(image_embed_dim, cross_dim * num_tokens)
        self.norm = LayerNorm(cross_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        out = self.proj(image_embeds)
        return self.norm(out.reshape(out.shape[0], self.num_tokens, -1))


# ---------------------------------------------------------------------------
# unet wiring
# ---------------------------------------------------------------------------


def attn2_site_order(unet_cfg) -> list[tuple[str, int, int, int]]:
    """The published attn-processor traversal restricted to the cross-attention sites: down
    blocks, mid, up blocks, as (kind, block_idx, attention_idx, tblock_idx)."""
    sites = []
    n = len(unet_cfg.block_out_channels)
    for i in range(n):
        if unet_cfg.cross_attn_blocks[i]:
            for j in range(unet_cfg.layers_per_block):
                for t in range(unet_cfg.transformer_depth[i]):
                    sites.append(("down", i, j, t))
    for t in range(unet_cfg.mid_transformer_depth):
        sites.append(("mid", 0, 0, t))
    for i in range(n):
        di = n - 1 - i
        if unet_cfg.cross_attn_blocks[di]:
            for j in range(unet_cfg.layers_per_block + 1):
                for t in range(unet_cfg.transformer_depth[di]):
                    sites.append(("up", i, j, t))
    return sites


def attn2_modules(unet) -> list:
    """The UNet's attn2 modules in :func:`attn2_site_order`."""
    out = []
    for kind, bi, ai, ti in attn2_site_order(unet.cfg):
        level = unet.mid if kind == "mid" else getattr(unet, kind)[bi]
        out.append(level.attentions[ai].blocks[ti].attn2)
    return out


def insert_ip_into_unet(unet, adapters) -> None:
    """Attach the adapters' projections to every attn2 of ``unet``: ``adapters`` is indexed
    [site][adapter] (:class:`~diffsim_tpu_torch.ops.blocks.IPProjection` modules), sites in
    :func:`attn2_site_order`."""
    sites = attn2_modules(unet)
    if len(adapters) != len(sites):
        raise ValueError(f"{len(adapters)} IP-Adapter sites for a UNet with {len(sites)}")
    for attn, site in zip(sites, adapters):
        attn.ip = nn.ModuleList(site)
