"""UNet2DCondition (SD-1.5 and SDXL), NCHW inside, with first-class taps and an early exit.

Counterpart of ``diffsim_tpu/models/unet.py``. ``forward`` returns ``(eps_pred, taps)``. Tap
addresses are absolute block coordinates ``(block_idx, attn_idx, tblock_idx)`` under
``block in {'down', 'mid', 'up'}``; negative attn/tblock indices count from the end, resolved
exactly as the JAX ``_site_tap`` does.

The JAX scorer relies on XLA's dead-code elimination to stop the UNet after the tap site. Eager
PyTorch has none, so with a tap and ``stop_at_tap=True`` (the default) the forward returns
``(None, taps)`` as soon as the tap site has produced its tensors: with QKV or IP_QKV capture it
does not run the tap site's own attention or anything after it; with OUTPUT capture it stops
after the tap site's out-projection.

``ip_embeds`` (a list of per-adapter image tokens, (B, T, cross_dim) each) and ``ip_scale``
reach every attn2 that has IP-Adapter projections (``models/ip_adapter.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from diffsim_tpu_torch.ops.blocks import (
    Downsample,
    GroupNorm,
    ResnetBlock,
    SpatialTransformer,
    TimeMLP,
    Upsample,
    conv3x3,
    silu,
    timestep_embedding,
)
from diffsim_tpu_torch.ops.taps import TapSpec


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    # True at index i => down block i has cross-attention transformers (up path mirrored)
    cross_attn_blocks: tuple = (True, True, True, False)
    layers_per_block: int = 2
    transformer_depth: tuple = (1, 1, 1, 0)
    mid_transformer_depth: int = 1
    heads: tuple = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    linear_proj: bool = False
    norm_eps: float = 1e-5
    addition_embed: str | None = None  # 'text_time' for SDXL
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def sdxl() -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(320, 640, 1280),
            cross_attn_blocks=(False, True, True),
            transformer_depth=(0, 2, 10),
            mid_transformer_depth=10,
            heads=(5, 10, 20),
            cross_attention_dim=2048,
            linear_proj=True,
            addition_embed="text_time",
        )

    @staticmethod
    def tiny(cross_attention_dim: int = 32) -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(32, 64),
            cross_attn_blocks=(True, False),
            layers_per_block=1,
            transformer_depth=(1, 0),
            heads=(2, 2),
            cross_attention_dim=cross_attention_dim,
        )

    @staticmethod
    def tiny_xl(cross_attention_dim: int = 32) -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(32, 64),
            cross_attn_blocks=(False, True),
            layers_per_block=1,
            transformer_depth=(0, 2),
            mid_transformer_depth=2,
            heads=(2, 2),
            cross_attention_dim=cross_attention_dim,
            linear_proj=True,
            addition_embed="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=16 + 8 * 6,
        )

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def mid_heads(self) -> int:
        if self.cross_attn_blocks[-1]:
            return self.heads[-1]
        return self.heads[max(i for i, c in enumerate(self.cross_attn_blocks) if c)]


class _Level(nn.Module):
    """One down or up block: resnets, their transformers (may be empty), a resampler."""

    def __init__(self, resnets, attentions, resample=None, resample_name="downsample"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.resample_name = resample_name
        if resample is not None:
            self.add_module(resample_name, resample)

    @property
    def resample(self):
        return getattr(self, self.resample_name, None)


class _Mid(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        c, ted = cfg.block_out_channels[-1], cfg.time_embed_dim
        self.resnet1 = ResnetBlock(c, c, ted, cfg.norm_eps)
        self.attentions = nn.ModuleList([SpatialTransformer(
            c, cfg.mid_heads, cfg.cross_attention_dim, cfg.mid_transformer_depth,
            cfg.linear_proj)])
        self.resnet2 = ResnetBlock(c, c, ted, cfg.norm_eps)


def site_tap(tap: TapSpec | None, block: str, bidx: int, aidx: int, n_attn: int):
    """Whether the spatial transformer at (block, bidx, aidx) is the tap site; if so the
    intra-transformer tap dict (the JAX ``_site_tap``)."""
    if tap is None or tap.block != block:
        return None
    t_bidx, t_aidx, t_tblock = tap.address
    if block != "mid" and t_bidx != bidx:
        return None
    if t_aidx % n_attn != aidx:
        return None
    return {"tblock": t_tblock, "attn": tap.attn, "capture": tap.capture}


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        chans, ted, eps = cfg.block_out_channels, cfg.time_embed_dim, cfg.norm_eps
        self.time_embedding = TimeMLP(chans[0], ted)
        if cfg.addition_embed == "text_time":
            self.add_embedding = TimeMLP(cfg.projection_class_embeddings_input_dim, ted)
        self.conv_in = conv3x3(cfg.in_channels, chans[0])

        def transformer(c, i):
            return SpatialTransformer(c, cfg.heads[i], cfg.cross_attention_dim,
                                      cfg.transformer_depth[i], cfg.linear_proj)

        down, skip_channels, cin = [], [chans[0]], chans[0]
        for i, cout in enumerate(chans):
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(cin if j == 0 else cout, cout, ted, eps))
                if cfg.cross_attn_blocks[i]:
                    attns.append(transformer(cout, i))
                skip_channels.append(cout)
            last = i == len(chans) - 1
            if not last:
                skip_channels.append(cout)
            down.append(_Level(resnets, attns, None if last else Downsample(cout)))
            cin = cout
        self.down = nn.ModuleList(down)
        self.mid = _Mid(cfg)

        up, rev = [], list(reversed(chans))
        cin = rev[0]
        for i, cout in enumerate(rev):
            di = len(chans) - 1 - i
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                skip = skip_channels.pop()
                resnets.append(ResnetBlock((cin if j == 0 else cout) + skip, cout, ted, eps))
                if cfg.cross_attn_blocks[di]:
                    attns.append(transformer(cout, di))
            last = i == len(rev) - 1
            up.append(_Level(resnets, attns, None if last else Upsample(cout), "upsample"))
            cin = cout
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(chans[0], eps)
        self.conv_out = conv3x3(chans[0], cfg.out_channels)

    def forward(self, x, t, context, *, tap: TapSpec | None = None, stop_at_tap: bool = True,
                added_cond: dict | None = None, ip_embeds=None, ip_scale=None):
        """x: (B, C, H, W) noisy latents; t: scalar or (B,) timestep tensor; context:
        (B, 77, cdim) text embeddings; ``added_cond`` for SDXL: {'text_embeds': (B, 1280),
        'time_ids': (B, 6)}. Returns ``(eps_pred, taps)``; ``eps_pred`` is None when the forward
        stopped at the tap."""
        stop = stop_at_tap and tap is not None
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        emb = self.time_embedding(
            timestep_embedding(t, self.cfg.block_out_channels[0]).to(x.dtype))
        if self.cfg.addition_embed == "text_time":
            time_ids = added_cond["time_ids"]
            tproj = timestep_embedding(time_ids.reshape(-1), self.cfg.addition_time_embed_dim)
            add = torch.cat([added_cond["text_embeds"],
                             tproj.reshape(time_ids.shape[0], -1).to(x.dtype)], dim=-1)
            emb = emb + self.add_embedding(add.to(x.dtype))

        ip = dict(ip_embeds=ip_embeds, ip_scale=ip_scale)
        taps: dict = {}
        h = self.conv_in(x)
        skips = [h]
        for i, blk in enumerate(self.down):
            n_attn = max(len(blk.attentions), 1)
            for j, rn in enumerate(blk.resnets):
                h = rn(h, emb)
                if len(blk.attentions):
                    site = site_tap(tap, "down", i, j, n_attn)
                    h, tp = blk.attentions[j](h, context, tap=site, stop=stop, **ip)
                    taps.update(tp)
                    if tp and stop:
                        return None, taps
                skips.append(h)
            if blk.resample is not None:
                h = blk.resample(h)
                skips.append(h)

        h = self.mid.resnet1(h, emb)
        site = site_tap(tap, "mid", 0, 0, len(self.mid.attentions))
        h, tp = self.mid.attentions[0](h, context, tap=site, stop=stop, **ip)
        taps.update(tp)
        if tp and stop:
            return None, taps
        h = self.mid.resnet2(h, emb)

        for i, blk in enumerate(self.up):
            n_attn = max(len(blk.attentions), 1)
            for j, rn in enumerate(blk.resnets):
                h = rn(torch.cat([h, skips.pop()], dim=1), emb)
                if len(blk.attentions):
                    site = site_tap(tap, "up", i, j, n_attn)
                    h, tp = blk.attentions[j](h, context, tap=site, stop=stop, **ip)
                    taps.update(tp)
                    if tp and stop:
                        return None, taps
            if blk.resample is not None:
                h = blk.resample(h)

        h = self.conv_out(silu(self.norm_out(h)))
        return h, taps
