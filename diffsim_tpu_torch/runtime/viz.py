"""Visualisation helpers (the port's copy of ``diffsim_tpu/runtime/viz.py``): the heat map of
a tapped tensor, saved to a path the caller names. matplotlib is imported only when called."""

from __future__ import annotations

import numpy as np


def attention_heatmap(tap: np.ndarray, out_path: str) -> np.ndarray:
    """Render the spatial norm-softmax of one tapped tensor.

    ``tap``: (B, heads, S, D) Q/K/V or (B, S, D) output features from any scorer tap; the
    first batch row is visualized. Saves a heatmap PNG and returns the (side, side) map."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = np.asarray(tap, np.float32)
    if a.ndim == 4:  # (B, heads, S, D) -> (S, heads*D)
        a = a[0].transpose(1, 0, 2).reshape(a.shape[2], -1)
    else:
        a = a[0]
    side = int(round(a.shape[0] ** 0.5))
    norms = np.linalg.norm(a[: side * side].reshape(side, side, -1), axis=-1)
    e = np.exp(norms - norms.max())
    heat = e / e.sum()
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(heat, cmap="viridis")
    fig.colorbar(im)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return heat
