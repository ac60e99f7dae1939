"""Flat .npz param-tree storage: '/'-joined dict keys, integer list indices.

The port's own copy of ``diffsim_tpu/convert/store.py``: it reads and writes the same files.
A bfloat16 leaf, as the JAX converter writes it by default (``ml_dtypes.bfloat16`` through
``np.savez``), is stored as raw two-byte records (dtype ``|V2``); :func:`as_float32` reads those
as bf16 bit patterns, with numpy alone."""

from __future__ import annotations

import numpy as np


def _flatten(tree, prefix="", out=None):
    if out is None:
        out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


BF16 = np.dtype("V2")  # how numpy without ml_dtypes holds bf16: raw two-byte records


def bf16_to_float32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16 or ``|V2``) -> float32, exactly: they are a float32's high
    half."""
    return (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def float32_to_bf16(x) -> np.ndarray:
    """Floats -> bf16 bit patterns as ``|V2`` records, rounded to nearest even, NaN to the quiet
    NaN of its sign: the bytes ``ml_dtypes.bfloat16`` holds for the same values."""
    u = np.asarray(x, np.float32).view(np.uint32)
    rounded = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
    nan = ((u >> 16) & 0x8000) | 0x7FC0
    bits = np.where(np.isnan(u.view(np.float32)), nan, rounded).astype(np.uint16)
    return bits.view(BF16)


def as_float32(leaf) -> np.ndarray:
    """A leaf as float32; ``|V2`` leaves are read as bf16 bit patterns."""
    arr = np.asarray(leaf)
    if arr.dtype == BF16:
        return bf16_to_float32(arr)
    return np.asarray(arr, np.float32)


def save_params(path: str, tree) -> None:
    """Write ``tree`` as a flat ``.npz``, the inverse of :func:`load_params`."""
    np.savez(path, **_flatten(tree))


def load_params(path: str):
    """Rebuild the nested tree; integer path segments become list indices, and bf16 leaves
    (``|V2``) are read as float32."""
    with np.load(path) as flat:
        return unflatten({k: as_float32(v) if v.dtype == BF16 else v for k, v in flat.items()})


def unflatten(flat: dict):
    """{'a/0/b': leaf} -> {'a': [{'b': leaf}]}, the inverse of ``_flatten``."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}
