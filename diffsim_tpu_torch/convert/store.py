"""Flat .npz param-tree storage: '/'-joined dict keys, integer list indices.

The port's own copy of ``diffsim_tpu/convert/store.py``: it reads the same files."""

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


def load_params(path: str):
    """Rebuild the nested tree; integer path segments become list indices."""
    return unflatten(dict(np.load(path)))


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
