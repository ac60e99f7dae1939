"""Published SAM checkpoints (``sam_vit_{b,l,h}.pth``, torch state dicts) -> the ``sam`` tree
of ``models/sam.py``, with numpy alone.

The port's copy of ``diffsim_tpu/convert/sam_import.py``: the same leaves and the same key
accounting (``strict`` raises on any key left unconsumed). The names follow the published
segment-anything checkpoints (``image_encoder.*``, ``prompt_encoder.*``, ``mask_decoder.*``).
Layouts, as everywhere in the JAX tree: torch Linear (out, in) -> dense (in, out); Conv2d OIHW
-> HWIO; ConvTranspose2d (in, out, kh, kw) -> (kh, kw, in, out).
"""

from __future__ import annotations

import numpy as np


def _take(sd, used, key):
    used.add(key)
    return np.asarray(sd[key])


def _lin(sd, used, name, bias=True):
    p = {"w": _take(sd, used, f"{name}.weight").T}
    if bias:
        p["b"] = _take(sd, used, f"{name}.bias")
    return p


def _norm(sd, used, name):
    return {"scale": _take(sd, used, f"{name}.weight"),
            "bias": _take(sd, used, f"{name}.bias")}


def _conv(sd, used, name, bias=True):
    p = {"w": _take(sd, used, f"{name}.weight").transpose(2, 3, 1, 0)}
    if bias:
        p["b"] = _take(sd, used, f"{name}.bias")
    return p


def _convt(sd, used, name):
    # ConvTranspose2d weight (in, out, kh, kw) -> (kh, kw, in, out)
    return {"w": _take(sd, used, f"{name}.weight").transpose(2, 3, 0, 1),
            "b": _take(sd, used, f"{name}.bias")}


def _dec_attn(sd, used, base):
    return {
        "q": _lin(sd, used, f"{base}.q_proj"),
        "k": _lin(sd, used, f"{base}.k_proj"),
        "v": _lin(sd, used, f"{base}.v_proj"),
        "out": _lin(sd, used, f"{base}.out_proj"),
    }


def _mlp3(sd, used, base):
    return {
        "fc1": _lin(sd, used, f"{base}.layers.0"),
        "fc2": _lin(sd, used, f"{base}.layers.1"),
        "fc3": _lin(sd, used, f"{base}.layers.2"),
    }


def convert_sam(sd: dict, cfg, strict: bool = True) -> dict:
    """cfg: ``models.sam.SamConfig`` (``vit_b()`` for sam_vit_b_01ec64.pth, etc.)."""
    used: set[str] = set()

    # ---- image encoder -----------------------------------------------------
    enc = {
        "patch_embed": _conv(sd, used, "image_encoder.patch_embed.proj"),
        "pos_embed": _take(sd, used, "image_encoder.pos_embed")[0],
        "blocks": [],
        "neck": {
            "conv1": _conv(sd, used, "image_encoder.neck.0", bias=False),
            "ln1": _norm(sd, used, "image_encoder.neck.1"),
            "conv2": _conv(sd, used, "image_encoder.neck.2", bias=False),
            "ln2": _norm(sd, used, "image_encoder.neck.3"),
        },
    }
    for i in range(cfg.encoder_depth):
        b = f"image_encoder.blocks.{i}"
        enc["blocks"].append({
            "norm1": _norm(sd, used, f"{b}.norm1"),
            "attn": {
                "qkv": _lin(sd, used, f"{b}.attn.qkv"),
                "proj": _lin(sd, used, f"{b}.attn.proj"),
                "rel_pos_h": _take(sd, used, f"{b}.attn.rel_pos_h"),
                "rel_pos_w": _take(sd, used, f"{b}.attn.rel_pos_w"),
            },
            "norm2": _norm(sd, used, f"{b}.norm2"),
            "mlp": {
                "fc1": _lin(sd, used, f"{b}.mlp.lin1"),
                "fc2": _lin(sd, used, f"{b}.mlp.lin2"),
            },
        })

    # ---- prompt encoder ----------------------------------------------------
    pe = {
        "pe_gaussian": _take(sd, used, "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
        "point_embeddings": [
            _take(sd, used, f"prompt_encoder.point_embeddings.{i}.weight")[0] for i in range(4)
        ],
        "not_a_point": _take(sd, used, "prompt_encoder.not_a_point_embed.weight")[0],
        "no_mask": _take(sd, used, "prompt_encoder.no_mask_embed.weight")[0],
        "mask_downscaling": {
            "conv1": _conv(sd, used, "prompt_encoder.mask_downscaling.0"),
            "ln1": _norm(sd, used, "prompt_encoder.mask_downscaling.1"),
            "conv2": _conv(sd, used, "prompt_encoder.mask_downscaling.3"),
            "ln2": _norm(sd, used, "prompt_encoder.mask_downscaling.4"),
            "conv3": _conv(sd, used, "prompt_encoder.mask_downscaling.6"),
        },
    }

    # ---- mask decoder ------------------------------------------------------
    dec = {
        "iou_token": _take(sd, used, "mask_decoder.iou_token.weight")[0],
        "mask_tokens": _take(sd, used, "mask_decoder.mask_tokens.weight"),
        "layers": [],
        "final_attn": _dec_attn(sd, used, "mask_decoder.transformer.final_attn_token_to_image"),
        "norm_final": _norm(sd, used, "mask_decoder.transformer.norm_final_attn"),
        "upscale": {
            "convt1": _convt(sd, used, "mask_decoder.output_upscaling.0"),
            "ln": _norm(sd, used, "mask_decoder.output_upscaling.1"),
            "convt2": _convt(sd, used, "mask_decoder.output_upscaling.3"),
        },
        "hyper_mlps": [
            _mlp3(sd, used, f"mask_decoder.output_hypernetworks_mlps.{i}")
            for i in range(cfg.num_mask_tokens)
        ],
        "iou_head": _mlp3(sd, used, "mask_decoder.iou_prediction_head"),
    }
    for i in range(cfg.decoder_depth):
        b = f"mask_decoder.transformer.layers.{i}"
        dec["layers"].append({
            "self_attn": _dec_attn(sd, used, f"{b}.self_attn"),
            "norm1": _norm(sd, used, f"{b}.norm1"),
            "cross_t2i": _dec_attn(sd, used, f"{b}.cross_attn_token_to_image"),
            "norm2": _norm(sd, used, f"{b}.norm2"),
            "mlp": {
                "fc1": _lin(sd, used, f"{b}.mlp.lin1"),
                "fc2": _lin(sd, used, f"{b}.mlp.lin2"),
            },
            "norm3": _norm(sd, used, f"{b}.norm3"),
            "cross_i2t": _dec_attn(sd, used, f"{b}.cross_attn_image_to_token"),
            "norm4": _norm(sd, used, f"{b}.norm4"),
        })

    leftover = set(sd) - used
    if strict and leftover:
        raise ValueError(f"unconsumed sam keys: {sorted(leftover)[:10]}")
    return {"image_encoder": enc, "prompt_encoder": pe, "mask_decoder": dec}
