"""The weight-free matting of ``--use_mask`` without ``--mask_path``.

The port's copy of ``heuristic_matting`` from ``diffsim_tpu/metrics/ffa.py`` (numpy only). The
rest of that module, the ``cute`` metric and its U^2-Net matting, comes with ROADMAP Queue 1
item 6.
"""

from __future__ import annotations

import warnings

import numpy as np
from PIL import Image


class MattingInversionWarning(UserWarning):
    """A heuristic matte was inverted (the object dominates the border). Registered 'always',
    so that each image warns, not only the first."""


warnings.filterwarnings("always", category=MattingInversionWarning)


def heuristic_matting(image: Image.Image, threshold: float = 60.0,
                      center_prior: bool = True) -> Image.Image:
    """Border-statistics alpha matte: pixels within ``threshold`` L2 distance of the median
    border colour get alpha 0. With ``center_prior``, a matte that covers the border more than
    the image's centre third is inverted (the object filled the border, so the median border
    colour was the object's), with a :class:`MattingInversionWarning`."""
    rgb = np.asarray(image.convert("RGB"), np.float32)
    border = np.concatenate([rgb[0], rgb[-1], rgb[:, 0], rgb[:, -1]], axis=0)
    bg = np.median(border, axis=0)
    dist = np.sqrt(((rgb - bg) ** 2).sum(-1))
    fg = dist > threshold
    if center_prior:
        h, w = fg.shape
        center_cov = fg[h // 3: h - h // 3, w // 3: w - w // 3].mean()
        border_cov = np.concatenate([fg[0], fg[-1], fg[:, 0], fg[:, -1]]).mean()
        if border_cov > center_cov:
            warnings.warn(
                "heuristic_matting: matte looks inverted (object dominates the image border, "
                f"border coverage {border_cov:.2f} > center {center_cov:.2f}): using the "
                "inverted matte. Pass --mask_path for reliable masks on close-ups.",
                MattingInversionWarning, stacklevel=2)
            fg = ~fg
    alpha = fg.astype(np.uint8) * 255
    return Image.fromarray(np.dstack([rgb.astype(np.uint8), alpha]), "RGBA")
