"""The weight bridge: the JAX package's parameter trees -> the port's module state.

A JAX tree is nested dicts/lists of numpy arrays, as ``jax.device_get`` returns them or as
``convert/store.load_params`` reads them from a ``.npz``. The port's modules name their
parameters after the same tree paths ('/' -> '.'), with torch's leaf names:

* ``w`` of rank 4 (conv, HWIO) -> ``weight`` in OIHW;
* ``w`` of rank 2 (dense, (in, out)) -> ``weight`` in nn.Linear's (out, in) — K2's weights
  included, since the K2 kernel takes the nn.Linear layout;
* ``b`` -> ``bias``; norm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
* the text towers' ``token_embedding`` / ``position_embedding`` tables as they are (``text``
  and SDXL's ``text2``, whose ``text_projection`` is a dense ``w`` without a bias);
* DiT's ``pos_embed`` and ``y_embedder`` tables as they are (``dit``). Its ``patch_embed`` is a
  dense (p*p*C, hidden) over (ph, pw, C)-ordered patches in both packages, so the dense rule
  maps it to the port's ``nn.Linear`` (``models/dit.py``), as it maps the CLIP vision tower's
  ``patch_embedding`` (``clip_vision``, whose ``class_embedding`` and ``position_embedding``
  are tables);
* the baseline metrics' models: the CLIP pair (``clip``: the ``vision`` and ``text`` towers of
  B/32 in one tree, their embedding and position tables as they are), DINOv2 / DINO v1
  (``dino``: ``cls_token``, ``position_embedding`` and each layer's LayerScale ``ls1`` / ``ls2``
  as they are), VGG (``vgg``: ``convs``), LPIPS (``lpips``: the VGG-16 trunk and the 1-D ``lins``
  weights as they are) and U^2-Net (``u2net``: each BatchNorm's ``mean`` / ``var`` as they
  are, its ``scale`` / ``bias`` as a norm's) and SAM (``sam``: the position, Fourier, token and
  prompt-role tables as they are, each block's ``rel_pos_h`` / ``rel_pos_w`` as they are, and the
  decoder's ``convt1`` / ``convt2`` kernels (kh, kw, in, out) in ``nn.ConvTranspose2d``'s
  (in, out, kh, kw));
* the IP-Adapter: its projection head (``ip_proj``: the Resampler with its ``latents`` table,
  or the plain ImageProjection) and, in the ``unet`` kind, each attn2's per-adapter
  ``ip/<i>/to_k_ip`` / ``to_v_ip``. The plain head's ``num_tokens`` leaf is configuration, not a
  parameter: the bridge checks it against the projection's shape, leaves it out of the state and
  writes it back in :func:`to_jax_tree`.

Leaves are read as float32 (``store.as_float32``: bf16 leaves of a ``.npz`` included) and placed
in the module's dtype.

The bridge is strict: a leaf it cannot place raises in :func:`from_jax_tree`, and
:func:`load` raises on any parameter the module expects but the tree lacks, or on a shape
mismatch (``load_state_dict(strict=True)``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from diffsim_tpu_torch.convert.store import _flatten, as_float32, unflatten

KINDS = ("unet", "vae", "vae_decoder", "text", "text2", "dit", "clip_vision", "ip_proj", "clip",
         "dino", "vgg", "lpips", "u2net", "sam")
# the leaves each kind keeps as they are, by path: embedding and position tables
_TABLES = {"text": ("token_embedding", "position_embedding"),
           "text2": ("token_embedding", "position_embedding"),
           "dit": ("pos_embed", "y_embedder"),
           "clip_vision": ("class_embedding", "position_embedding"),
           "ip_proj": ("latents",),
           "clip": ("vision/class_embedding", "vision/position_embedding",
                    "text/token_embedding", "text/position_embedding"),
           "dino": ("cls_token", "position_embedding"),
           "sam": ("image_encoder/pos_embed", "prompt_encoder/pe_gaussian",
                   *(f"prompt_encoder/point_embeddings/{i}" for i in range(4)),
                   "prompt_encoder/not_a_point", "prompt_encoder/no_mask",
                   "mask_decoder/iou_token", "mask_decoder/mask_tokens")}
# the 1-D leaves each kind keeps as they are, by name at any depth
_KEPT = {"dino": ("ls1", "ls2"), "lpips": ("w",), "u2net": ("mean", "var")}
# the leaves each kind keeps as they are, by name at any depth and of any rank
_KEPT_TABLES = {"sam": ("rel_pos_h", "rel_pos_w")}
# the parents, by name, of the transposed-convolution kernels: (kh, kw, in, out) <-> (in, out,
# kh, kw), the same permutation both ways
_CONV_T = {"sam": ("convt1", "convt2")}


def _num_tokens(proj_rows: int, norm_dim: int) -> int:
    """The plain ImageProjection's token count, from its projection's and norm's widths."""
    return proj_rows // norm_dim


def _convert(path: str, leaf: np.ndarray, kind: str) -> tuple[str, np.ndarray]:
    *prefix, name = path.split("/")
    arr = np.asarray(leaf)
    if path in _TABLES.get(kind, ()):
        return path.replace("/", "."), arr
    if name in _KEPT.get(kind, ()) and arr.ndim == 1 or name in _KEPT_TABLES.get(kind, ()):
        return ".".join(prefix + [name]), arr
    if name == "w" and arr.ndim == 4 and prefix and prefix[-1] in _CONV_T.get(kind, ()):
        return ".".join(prefix + ["weight"]), arr.transpose(2, 3, 0, 1)
    if name == "w" and arr.ndim == 4:
        return ".".join(prefix + ["weight"]), arr.transpose(3, 2, 0, 1)
    if name == "w" and arr.ndim == 2:
        return ".".join(prefix + ["weight"]), arr.T
    if name in ("b", "bias") and arr.ndim == 1:
        return ".".join(prefix + ["bias"]), arr
    if name == "scale" and arr.ndim == 1:
        return ".".join(prefix + ["weight"]), arr
    raise KeyError(f"bridge ({kind}): no rule for leaf {path!r} of shape {arr.shape}")


def from_jax_tree(tree, kind: str) -> dict[str, np.ndarray]:
    """The JAX parameter tree of a ``kind`` model (one of :data:`KINDS`) as the port's flat
    state: {parameter name: numpy array in the port's layout}. Every leaf is consumed."""
    if kind not in KINDS:
        raise ValueError(f"bridge: unknown kind {kind!r} (one of {KINDS})")
    flat = _flatten(tree)
    if kind == "ip_proj" and "num_tokens" in flat:
        n = int(flat.pop("num_tokens"))
        if n != _num_tokens(flat["proj/w"].shape[1], flat["norm/scale"].shape[0]):
            raise ValueError(f"bridge (ip_proj): num_tokens {n} does not match the projection "
                             f"{flat['proj/w'].shape} and norm {flat['norm/scale'].shape}")
    state = {}
    for path, leaf in flat.items():
        key, arr = _convert(path, leaf, kind)
        if key in state:
            raise KeyError(f"bridge ({kind}): two leaves map to {key!r}")
        state[key] = np.ascontiguousarray(arr)
    return state


def load(module: nn.Module, tree, kind: str, device, dtype) -> nn.Module:
    """Fill ``module`` (typically built on the meta device) from a JAX tree, strictly: every
    leaf of the tree is consumed and every parameter of the module is provided, with the
    module's shapes. Tensors are placed on ``device`` in ``dtype``."""
    state = {k: torch.tensor(as_float32(v), dtype=dtype, device=device)
             for k, v in from_jax_tree(tree, kind).items()}
    module.load_state_dict(state, strict=True, assign=True)
    return module


def to_jax_tree(state, kind: str):
    """The inverse of :func:`from_jax_tree`: a port state {name: tensor or array} as the JAX
    package's parameter tree of numpy arrays (conv OIHW -> HWIO, dense (out, in) -> (in, out),
    norm ``weight`` -> ``scale``)."""
    if kind not in KINDS:
        raise ValueError(f"bridge: unknown kind {kind!r} (one of {KINDS})")
    arrays = {k: v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v) for k, v in state.items()}
    flat = {}
    for name, arr in arrays.items():
        path = name.replace(".", "/")
        if path in _TABLES.get(kind, ()):
            flat[path] = arr
            continue
        prefix, leaf = name.rsplit(".", 1)
        if leaf in _KEPT.get(kind, ()) and arr.ndim == 1 or leaf in _KEPT_TABLES.get(kind, ()):
            flat[path] = arr
            continue
        norm = arrays[f"{prefix}.weight"].ndim == 1
        convt = prefix.rsplit(".", 1)[-1] in _CONV_T.get(kind, ())
        if leaf == "weight" and arr.ndim == 4 and convt:
            key, arr = "w", arr.transpose(2, 3, 0, 1)
        elif leaf == "weight":
            key, arr = ("scale", arr) if norm else (
                "w", arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T)
        elif leaf == "bias":
            key = "bias" if norm else "b"
        else:
            raise KeyError(f"bridge ({kind}): no rule for parameter {name!r}")
        flat["/".join(prefix.split(".") + [key])] = np.ascontiguousarray(arr)
    if kind == "ip_proj" and "proj/w" in flat:
        flat["num_tokens"] = np.asarray(_num_tokens(flat["proj/w"].shape[1],
                                                    flat["norm/scale"].shape[0]))
    return unflatten(flat)
