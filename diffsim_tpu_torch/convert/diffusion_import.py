"""Torch -> parameter-tree converters for the diffusion stacks: SD-1.5 / SDXL UNet,
AutoencoderKL, DiT checkpoints, with numpy alone.

The port's own copy of ``diffsim_tpu/convert/diffusion_import.py``: the same trees, leaf for
leaf, so a ``.npz`` from either package's converter loads in either. Key layouts follow the
published diffusers / DiT state-dict naming. Every converter tracks consumed keys;
``strict=True`` (default) raises on any unconsumed tensor, so naming drift in a future
checkpoint fails loudly instead of silently loading a partial model.
"""

from __future__ import annotations

import numpy as np

from diffsim_tpu_torch.convert.store import float32_to_bf16
from diffsim_tpu_torch.convert.torch_import import _patch_conv_to_dense


class _SD:
    """State-dict view that records consumed keys."""

    def __init__(self, sd: dict):
        self.sd = sd
        self.used: set[str] = set()

    def __contains__(self, k):
        return k in self.sd

    def take(self, k):
        self.used.add(k)
        return self.sd[k]

    def lin(self, name):
        p = {"w": self.take(f"{name}.weight").T}
        if f"{name}.bias" in self.sd:
            p["b"] = self.take(f"{name}.bias")
        return p

    def conv(self, name):
        p = {"w": self.take(f"{name}.weight").transpose(2, 3, 1, 0)}
        if f"{name}.bias" in self.sd:
            p["b"] = self.take(f"{name}.bias")
        return p

    def norm(self, name):
        return {"scale": self.take(f"{name}.weight"), "bias": self.take(f"{name}.bias")}

    def finish(self, strict):
        leftover = set(self.sd) - self.used
        if strict and leftover:
            raise ValueError(f"unconsumed checkpoint keys: {sorted(leftover)[:10]} "
                             f"(+{max(0, len(leftover) - 10)} more)")


def _attention(s: _SD, base: str):
    # diffusers Attention: to_q/k/v no bias, to_out.0 with bias (to_out.1 is dropout)
    return {
        "to_q": s.lin(f"{base}.to_q"),
        "to_k": s.lin(f"{base}.to_k"),
        "to_v": s.lin(f"{base}.to_v"),
        "to_out": s.lin(f"{base}.to_out.0"),
    }


def _transformer_block(s: _SD, base: str):
    return {
        "norm1": s.norm(f"{base}.norm1"),
        "attn1": _attention(s, f"{base}.attn1"),
        "norm2": s.norm(f"{base}.norm2"),
        "attn2": _attention(s, f"{base}.attn2"),
        "norm3": s.norm(f"{base}.norm3"),
        "ff": {
            "proj_in": s.lin(f"{base}.ff.net.0.proj"),
            "proj_out": s.lin(f"{base}.ff.net.2"),
        },
    }


def _spatial_transformer(s: _SD, base: str, linear_proj: bool):
    depth = 0
    while f"{base}.transformer_blocks.{depth}.norm1.weight" in s:
        depth += 1
    proj = s.lin if linear_proj else s.conv
    return {
        "norm": s.norm(f"{base}.norm"),
        "proj_in": proj(f"{base}.proj_in"),
        "blocks": [_transformer_block(s, f"{base}.transformer_blocks.{k}") for k in range(depth)],
        "proj_out": proj(f"{base}.proj_out"),
    }


def _resnet(s: _SD, base: str):
    p = {
        "norm1": s.norm(f"{base}.norm1"),
        "conv1": s.conv(f"{base}.conv1"),
        "norm2": s.norm(f"{base}.norm2"),
        "conv2": s.conv(f"{base}.conv2"),
    }
    if f"{base}.time_emb_proj.weight" in s:
        p["time_emb_proj"] = s.lin(f"{base}.time_emb_proj")
    if f"{base}.conv_shortcut.weight" in s:
        p["shortcut"] = s.conv(f"{base}.conv_shortcut")
    return p


def convert_sd_unet(sd: dict, cfg, strict: bool = True) -> dict:
    """diffusers UNet2DConditionModel -> models.unet tree (SD-1.5 and SDXL)."""
    s = _SD(sd)
    p: dict = {
        "conv_in": s.conv("conv_in"),
        "time_embedding": {
            "fc1": s.lin("time_embedding.linear_1"),
            "fc2": s.lin("time_embedding.linear_2"),
        },
    }
    if "add_embedding.linear_1.weight" in s:
        p["add_embedding"] = {
            "fc1": s.lin("add_embedding.linear_1"),
            "fc2": s.lin("add_embedding.linear_2"),
        }

    down = []
    for i in range(len(cfg.block_out_channels)):
        blk: dict = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            blk["resnets"].append(_resnet(s, f"down_blocks.{i}.resnets.{j}"))
            if cfg.cross_attn_blocks[i]:
                blk["attentions"].append(
                    _spatial_transformer(s, f"down_blocks.{i}.attentions.{j}", cfg.linear_proj)
                )
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in s:
            blk["downsample"] = s.conv(f"down_blocks.{i}.downsamplers.0.conv")
        down.append(blk)
    p["down"] = down

    p["mid"] = {
        "resnet1": _resnet(s, "mid_block.resnets.0"),
        "attentions": [_spatial_transformer(s, "mid_block.attentions.0", cfg.linear_proj)],
        "resnet2": _resnet(s, "mid_block.resnets.1"),
    }

    up = []
    for i in range(len(cfg.block_out_channels)):
        di = len(cfg.block_out_channels) - 1 - i
        blk = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            blk["resnets"].append(_resnet(s, f"up_blocks.{i}.resnets.{j}"))
            if cfg.cross_attn_blocks[di]:
                blk["attentions"].append(
                    _spatial_transformer(s, f"up_blocks.{i}.attentions.{j}", cfg.linear_proj)
                )
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in s:
            blk["upsample"] = s.conv(f"up_blocks.{i}.upsamplers.0.conv")
        up.append(blk)
    p["up"] = up

    p["norm_out"] = s.norm("conv_norm_out")
    p["conv_out"] = s.conv("conv_out")
    s.finish(strict)
    return p


def convert_vae(sd: dict, cfg, strict: bool = True) -> dict:
    """diffusers AutoencoderKL -> (encoder_params, decoder_params)."""
    s = _SD(sd)
    n = len(cfg.block_out_channels)

    def mid(base):
        return {
            "resnet1": _resnet(s, f"{base}.resnets.0"),
            "attn": {
                "norm": s.norm(f"{base}.attentions.0.group_norm"),
                "to_q": s.lin(f"{base}.attentions.0.to_q"),
                "to_k": s.lin(f"{base}.attentions.0.to_k"),
                "to_v": s.lin(f"{base}.attentions.0.to_v"),
                "to_out": s.lin(f"{base}.attentions.0.to_out.0"),
            },
            "resnet2": _resnet(s, f"{base}.resnets.1"),
        }

    enc = {
        "conv_in": s.conv("encoder.conv_in"),
        "down": [],
        "mid": mid("encoder.mid_block"),
        "norm_out": s.norm("encoder.conv_norm_out"),
        "conv_out": s.conv("encoder.conv_out"),
        "quant_conv": s.conv("quant_conv"),
    }
    for i in range(n):
        blk = {
            "resnets": [
                _resnet(s, f"encoder.down_blocks.{i}.resnets.{j}")
                for j in range(cfg.layers_per_block)
            ]
        }
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in s:
            blk["downsample"] = s.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv")
        enc["down"].append(blk)

    dec = {
        "post_quant_conv": s.conv("post_quant_conv"),
        "conv_in": s.conv("decoder.conv_in"),
        "mid": mid("decoder.mid_block"),
        "up": [],
        "norm_out": s.norm("decoder.conv_norm_out"),
        "conv_out": s.conv("decoder.conv_out"),
    }
    for i in range(n):
        blk = {
            "resnets": [
                _resnet(s, f"decoder.up_blocks.{i}.resnets.{j}")
                for j in range(cfg.layers_per_block + 1)
            ]
        }
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in s:
            blk["upsample"] = s.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv")
        dec["up"].append(blk)
    s.finish(strict)
    return enc, dec


def convert_dit(sd: dict, cfg, strict: bool = True) -> dict:
    """Published DiT checkpoint ('DiT-XL-2-*.pt' model/ema inner dict) -> models.dit tree.

    The reference loads tolerantly, dropping mismatched shapes; pass strict=False for the same
    behaviour. Layout notes: x_embedder's conv kernel flattens to the (ph, pw, C)-ordered dense
    of ``models/dit.py``; the final layer needs no permute (the published unpatchify uses the
    same (p, q, c) feature order). A checkpoint without ``pos_embed`` gets the fixed sin-cos
    table (``models/dit.pos_embed_2d``)."""
    s = _SD(sd)
    depth = 0
    while f"blocks.{depth}.attn.qkv.weight" in s:
        depth += 1
    p = {
        "patch_embed": {
            "w": _patch_conv_to_dense(s.take("x_embedder.proj.weight")),
            "b": s.take("x_embedder.proj.bias"),
        },
        "pos_embed": s.take("pos_embed").reshape(-1, cfg.hidden)
        if "pos_embed" in s
        else None,
        "t_embedder": {
            "fc1": s.lin("t_embedder.mlp.0"),
            "fc2": s.lin("t_embedder.mlp.2"),
        },
        "y_embedder": s.take("y_embedder.embedding_table.weight"),
        "blocks": [
            {
                "attn": {
                    "qkv": s.lin(f"blocks.{i}.attn.qkv"),
                    "proj": s.lin(f"blocks.{i}.attn.proj"),
                },
                "mlp": {
                    "fc1": s.lin(f"blocks.{i}.mlp.fc1"),
                    "fc2": s.lin(f"blocks.{i}.mlp.fc2"),
                },
                "adaLN": s.lin(f"blocks.{i}.adaLN_modulation.1"),
            }
            for i in range(depth)
        ],
        "final": {
            "adaLN": s.lin("final_layer.adaLN_modulation.1"),
            "linear": s.lin("final_layer.linear"),
        },
    }
    if p["pos_embed"] is None:
        from diffsim_tpu_torch.models.dit import pos_embed_2d

        p["pos_embed"] = pos_embed_2d(cfg.hidden, cfg.tokens_per_side)
    s.finish(strict)
    return p


def cast_tree(tree, dtype):
    """Every leaf of a nested dict / list / tuple tree cast to ``dtype``. ``"bfloat16"`` gives
    ``|V2`` leaves of round-to-nearest-even bf16 bit patterns (``store.float32_to_bf16``),
    byte for byte what the JAX converter's ``ml_dtypes.bfloat16`` cast stores."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if dtype == "bfloat16":
        return float32_to_bf16(tree)
    return np.asarray(tree, dtype)
