"""Torch state dict -> the JAX package's parameter-tree layout, with numpy alone.

The port's own copy of the parts of ``diffsim_tpu/convert/torch_import.py`` that the diffusion
families need (``convert/diffusion_import.py``, ``cli/convert.py``). Layout rules: torch Linear
(out, in) -> (in, out); torch Conv2d OIHW -> HWIO; patch-embedding convolutions -> dense over
(ph, pw, C)-flattened patches; LayerNorm / GroupNorm weight and bias -> scale and bias.

:func:`load_safetensors` reads the safetensors format itself (an 8-byte little-endian header
length, a JSON header, then raw little-endian data), so conversion needs neither the
``safetensors`` package nor ``ml_dtypes``. :func:`convert_clip_vision` and
:func:`convert_ip_adapter` convert the IP-Adapter's image encoder and adapter checkpoints;
:func:`convert_dinov2`, :func:`convert_dino_v1`, :func:`convert_vgg_features` and
:func:`convert_lpips` the baseline metrics' (``convert/u2net_import.py`` converts U^2-Net,
``convert/sam_import.py`` SAM).
"""

from __future__ import annotations

import json

import numpy as np

from diffsim_tpu_torch.convert.store import bf16_to_float32
from diffsim_tpu_torch.models.ip_adapter import attn2_site_order

# safetensors dtype -> numpy dtype (little-endian); BF16 is read as its float32 upcast
_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
                       "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def state_dict_numpy(module_or_sd) -> dict[str, np.ndarray]:
    """A torch module's (or state dict's) tensors as float32 numpy arrays."""
    if hasattr(module_or_sd, "state_dict"):
        module_or_sd = module_or_sd.state_dict()
    return {k: np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v)
            for k, v in module_or_sd.items()}


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """{name: array} of a ``.safetensors`` file. F32, F16 and the integer dtypes keep their
    dtype, as ``safetensors.numpy.load_file`` gives them; BF16 tensors are returned as their
    exact float32 upcast. Arrays are read-only views of a memory map of the file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        dtype = info["dtype"]
        if dtype == "BF16":
            raw, np_dtype = data[begin:end].view("<u2"), None
        elif dtype in _SAFETENSORS_DTYPES:
            np_dtype = np.dtype(_SAFETENSORS_DTYPES[dtype])
            raw = data[begin:end].view(np_dtype)
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, which the reader does "
                             f"not take (BF16 or one of {sorted(_SAFETENSORS_DTYPES)})")
        if raw.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} does not match its "
                             f"bytes [{begin}, {end})")
        raw = np.asarray(raw).reshape(shape)
        out[name] = bf16_to_float32(raw) if np_dtype is None else raw
    return out


def _lin(sd, name):
    p = {"w": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _norm(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _conv(sd, name):
    p = {"w": sd[f"{name}.weight"].transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _patch_conv_to_dense(w_oihw: np.ndarray) -> np.ndarray:
    """(D, C, ph, pw) conv kernel -> (ph*pw*C, D) dense over (ph, pw, C)-ordered patches."""
    d = w_oihw.shape[0]
    return w_oihw.transpose(2, 3, 1, 0).reshape(-1, d)


def convert_clip_text(sd: dict, cfg) -> dict:
    """HF CLIPTextModel (or the text tower of CLIPModel) -> the ``text`` / ``text2`` tree."""
    pre = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    p = {
        "token_embedding": sd[f"{pre}embeddings.token_embedding.weight"],
        "position_embedding": sd[f"{pre}embeddings.position_embedding.weight"],
        "layers": _encoder_layers(sd, pre, cfg.layers),
        "final_norm": _norm(sd, f"{pre}final_layer_norm"),
    }
    if "text_projection.weight" in sd:
        p["text_projection"] = {"w": sd["text_projection.weight"].T}
    return p


def _encoder_layers(sd: dict, pre: str, n: int) -> list:
    """The ``n`` HF CLIP encoder layers under ``pre`` in the JAX layout."""
    layers = []
    for i in range(n):
        base = f"{pre}encoder.layers.{i}"
        layers.append(
            {
                "norm1": _norm(sd, f"{base}.layer_norm1"),
                "attn": {
                    "q": _lin(sd, f"{base}.self_attn.q_proj"),
                    "k": _lin(sd, f"{base}.self_attn.k_proj"),
                    "v": _lin(sd, f"{base}.self_attn.v_proj"),
                    "out": _lin(sd, f"{base}.self_attn.out_proj"),
                },
                "norm2": _norm(sd, f"{base}.layer_norm2"),
                "fc1": _lin(sd, f"{base}.mlp.fc1"),
                "fc2": _lin(sd, f"{base}.mlp.fc2"),
            }
        )
    return layers


def convert_clip_vision(sd: dict, cfg) -> dict:
    """HF CLIPVisionModel(WithProjection) (or the vision tower of CLIPModel) -> the
    ``clip_vision`` tree. Without a ``visual_projection`` the projection is the identity's
    first ``projection_dim`` columns, as in the JAX converter."""
    pre = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    p = {
        "class_embedding": sd[f"{pre}embeddings.class_embedding"].reshape(-1),
        "patch_embedding": {
            "w": _patch_conv_to_dense(sd[f"{pre}embeddings.patch_embedding.weight"])},
        "position_embedding": sd[f"{pre}embeddings.position_embedding.weight"],
        "pre_norm": _norm(sd, f"{pre}pre_layrnorm"),  # sic: HF's attribute name
        "layers": _encoder_layers(sd, pre, cfg.layers),
        "post_norm": _norm(sd, f"{pre}post_layernorm"),
    }
    if "visual_projection.weight" in sd:
        p["visual_projection"] = {"w": sd["visual_projection.weight"].T}
    else:
        p["visual_projection"] = {"w": np.eye(cfg.hidden, cfg.projection_dim, dtype=np.float32)}
    return p


def convert_dinov2(sd: dict, cfg) -> dict:
    """HF ``Dinov2Model`` -> the ``dino`` tree (LayerScale leaves when ``cfg.layerscale``)."""
    layers = []
    for i in range(cfg.layers):
        base = f"encoder.layer.{i}"
        layer = {
            "norm1": _norm(sd, f"{base}.norm1"),
            "attn": {
                "q": _lin(sd, f"{base}.attention.attention.query"),
                "k": _lin(sd, f"{base}.attention.attention.key"),
                "v": _lin(sd, f"{base}.attention.attention.value"),
                "out": _lin(sd, f"{base}.attention.output.dense"),
            },
            "norm2": _norm(sd, f"{base}.norm2"),
            "fc1": _lin(sd, f"{base}.mlp.fc1"),
            "fc2": _lin(sd, f"{base}.mlp.fc2"),
        }
        if cfg.layerscale:
            layer["ls1"] = sd[f"{base}.layer_scale1.lambda1"]
            layer["ls2"] = sd[f"{base}.layer_scale2.lambda1"]
        layers.append(layer)
    pos = sd["embeddings.position_embeddings"]
    return {
        "cls_token": sd["embeddings.cls_token"].reshape(-1),
        "patch_embedding": {
            "w": _patch_conv_to_dense(sd["embeddings.patch_embeddings.projection.weight"]),
            "b": sd["embeddings.patch_embeddings.projection.bias"],
        },
        "position_embedding": pos.reshape(-1, pos.shape[-1]),
        "layers": layers,
        "final_norm": _norm(sd, "layernorm"),
    }


def convert_dino_v1(sd: dict, cfg) -> dict:
    """facebookresearch/dino's ``VisionTransformer`` (fused qkv) -> the ``dino`` tree."""
    layers = []
    h = cfg.hidden
    for i in range(cfg.layers):
        base = f"blocks.{i}"
        qkv_w = sd[f"{base}.attn.qkv.weight"]  # (3h, h)
        qkv_b = sd.get(f"{base}.attn.qkv.bias", np.zeros(3 * h, np.float32))
        layers.append(
            {
                "norm1": _norm(sd, f"{base}.norm1"),
                "attn": {
                    "q": {"w": qkv_w[:h].T, "b": qkv_b[:h]},
                    "k": {"w": qkv_w[h:2 * h].T, "b": qkv_b[h:2 * h]},
                    "v": {"w": qkv_w[2 * h:].T, "b": qkv_b[2 * h:]},
                    "out": _lin(sd, f"{base}.attn.proj"),
                },
                "norm2": _norm(sd, f"{base}.norm2"),
                "fc1": _lin(sd, f"{base}.mlp.fc1"),
                "fc2": _lin(sd, f"{base}.mlp.fc2"),
            }
        )
    return {
        "cls_token": sd["cls_token"].reshape(-1),
        "patch_embedding": {
            "w": _patch_conv_to_dense(sd["patch_embed.proj.weight"]),
            "b": sd["patch_embed.proj.bias"],
        },
        "position_embedding": sd["pos_embed"].reshape(-1, sd["pos_embed"].shape[-1]),
        "layers": layers,
        "final_norm": _norm(sd, "norm"),
    }


def convert_vgg_features(sd: dict, cfg) -> dict:
    """torchvision's VGG ``.features`` ('features.N.weight', or bare 'N.weight') -> {'convs'}."""
    pre = "features." if any(k.startswith("features.") for k in sd) else ""
    convs = []
    idx = 0
    for item in cfg:
        if item == "M":
            idx += 1
            continue
        convs.append(_conv(sd, f"{pre}{idx}"))
        idx += 2  # conv + relu
    return {"convs": convs}


def convert_lpips(sd: dict, vgg_cfg) -> dict:
    """The published LPIPS checkpoint ('lin{i}.model.1.weight', (1, C, 1, 1) heads) -> {'lins'},
    plus 'vgg' when the trunk is merged in under 'net.' (else convert torchvision's VGG-16 with
    :func:`convert_vgg_features`)."""
    out = {"lins": [{"w": sd[f"lin{i}.model.1.weight"].reshape(-1)} for i in range(5)]}
    net = {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")}
    if net:
        out["vgg"] = convert_vgg_features(net, vgg_cfg)
    return out


def convert_ip_adapter(sd: dict, unet_cfg) -> dict:
    """A published ip-adapter(-plus) checkpoint -> {'image_proj': tree, 'ip_weights':
    [site][adapter] {'to_k_ip', 'to_v_ip'}, 'plus': bool}. Takes the flat safetensors layout
    ('image_proj.latents', 'ip_adapter.1.to_k_ip.weight') or a pre-split {'image_proj': {...},
    'ip_adapter': {...}} dict. The numbered ip_adapter keys follow the published attn-processor
    traversal, whose cross-attention processors are the odd indices 1, 3, 5, ..."""
    if "image_proj" in sd and isinstance(sd["image_proj"], dict):
        proj_sd = {k: np.asarray(v) for k, v in sd["image_proj"].items()}
        ip_sd = {k: np.asarray(v) for k, v in sd["ip_adapter"].items()}
    else:
        proj_sd = {k[len("image_proj."):]: v for k, v in sd.items()
                   if k.startswith("image_proj.")}
        ip_sd = {k[len("ip_adapter."):]: v for k, v in sd.items() if k.startswith("ip_adapter.")}

    plus = "latents" in proj_sd
    if plus:
        depth = 0
        while f"layers.{depth}.0.to_q.weight" in proj_sd:
            depth += 1
        image_proj = {
            "latents": proj_sd["latents"].reshape(proj_sd["latents"].shape[-2:]),
            "proj_in": _lin(proj_sd, "proj_in"),
            "proj_out": _lin(proj_sd, "proj_out"),
            "norm_out": _norm(proj_sd, "norm_out"),
            "layers": [
                {
                    "norm1": _norm(proj_sd, f"layers.{i}.0.norm1"),
                    "norm2": _norm(proj_sd, f"layers.{i}.0.norm2"),
                    "to_q": _lin(proj_sd, f"layers.{i}.0.to_q"),
                    "to_kv": _lin(proj_sd, f"layers.{i}.0.to_kv"),
                    "to_out": _lin(proj_sd, f"layers.{i}.0.to_out"),
                    "ff_norm": _norm(proj_sd, f"layers.{i}.1.0"),
                    "ff1": _lin(proj_sd, f"layers.{i}.1.1"),
                    "ff2": _lin(proj_sd, f"layers.{i}.1.3"),
                }
                for i in range(depth)
            ],
        }
    else:
        image_proj = {
            "proj": _lin(proj_sd, "proj"),
            "norm": _norm(proj_sd, "norm"),
            "num_tokens": np.asarray(proj_sd["proj.weight"].shape[0] // _infer_cross_dim(ip_sd)),
        }

    ip_weights = []
    for s_i in range(len(attn2_site_order(unet_cfg))):
        key = 2 * s_i + 1
        ip_weights.append([{"to_k_ip": {"w": ip_sd[f"{key}.to_k_ip.weight"].T},
                            "to_v_ip": {"w": ip_sd[f"{key}.to_v_ip.weight"].T}}])
    return {"image_proj": image_proj, "ip_weights": ip_weights, "plus": plus}


def _infer_cross_dim(ip_sd: dict) -> int:
    first = next(k for k in ip_sd if k.endswith("to_k_ip.weight"))
    return ip_sd[first].shape[1]
