"""Torch state dict -> the JAX package's parameter-tree layout, with numpy alone.

The port's own copy of the parts of ``diffsim_tpu/convert/torch_import.py`` that the diffusion
families need (``convert/diffusion_import.py``, ``cli/convert.py``). Layout rules: torch Linear
(out, in) -> (in, out); torch Conv2d OIHW -> HWIO; patch-embedding convolutions -> dense over
(ph, pw, C)-flattened patches; LayerNorm / GroupNorm weight and bias -> scale and bias.

:func:`load_safetensors` reads the safetensors format itself (an 8-byte little-endian header
length, a JSON header, then raw little-endian data), so conversion needs neither the
``safetensors`` package nor ``ml_dtypes``. The converters of the baseline metrics' models (CLIP
vision, DINO, VGG, LPIPS, IP-Adapter, U^2-Net, SAM) come with ROADMAP Queue 1 items 5 and 6.
"""

from __future__ import annotations

import json

import numpy as np

from diffsim_tpu_torch.convert.store import bf16_to_float32

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
    layers = []
    for i in range(cfg.layers):
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
    p = {
        "token_embedding": sd[f"{pre}embeddings.token_embedding.weight"],
        "position_embedding": sd[f"{pre}embeddings.position_embedding.weight"],
        "layers": layers,
        "final_norm": _norm(sd, f"{pre}final_layer_norm"),
    }
    if "text_projection.weight" in sd:
        p["text_projection"] = {"w": sd["text_projection.weight"].T}
    return p
