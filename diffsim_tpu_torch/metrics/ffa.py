"""Foreground Feature Averaging, the ``cute`` baseline, and the mattings it and ``--use_mask``
take, on PyTorch.

Counterpart of ``diffsim_tpu/metrics/ffa.py``. The pipeline: alpha matting -> the background
zeroed -> DINOv2 ViT-B/14 at 336 x 336 (577 tokens: the math path) -> a foreground mask from the
zeroed background, on the 24 x 24 patch grid -> the mean of the masked patch tokens -> cosine.
The matting is pluggable, as in JAX:

* :class:`U2NetMatting`: U^2-Net saliency (``models/u2net.py``), min-max normalised and cut at
  0.5 into a hard matte, whenever converted U^2-Net weights are given;
* :func:`heuristic_matting`: border statistics, weight-free (the default);
* any ``PIL -> RGBA PIL`` callable.

Scoring runs on ``cuda`` unless ``device`` is given; without a CUDA device and without a
``device`` the constructors raise.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from PIL import Image

from diffsim_tpu_torch.core.image import IMAGENET_MEAN, IMAGENET_STD
from diffsim_tpu_torch.metrics.scorer_base import (
    build_module,
    host_cosine,
    resolve_device,
    to_device_normalized,
)
from diffsim_tpu_torch.models.dinov2 import Dino, DinoConfig
from diffsim_tpu_torch.models.u2net import U2Net, U2NetConfig

_SIZE = 336
_GRID = 24  # 336 / 14
MATTE_SIZE = 320  # U^2-Net's input side


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
                "inverted matte. Supply U^2-Net weights (--matting_weights) or --mask_path "
                "for reliable masks on close-ups.",
                MattingInversionWarning, stacklevel=2)
            fg = ~fg
    alpha = fg.astype(np.uint8) * 255
    return Image.fromarray(np.dstack([rgb.astype(np.uint8), alpha]), "RGBA")


class U2NetMatting:
    """Model-based alpha matting: the U^2-Net saliency of the image resized (bilinear) to
    :data:`MATTE_SIZE`, min-max normalised (the published inference normalisation) and cut at
    0.5 into a hard alpha, resized back to the image (bilinear). FFA derives its patch mask
    from exactly-zeroed background pixels, so a binary matte matches the matted input the
    reference feeds it. ``params`` is the JAX U^2-Net tree (u2netp by default), bridged
    strictly; the network runs in float32."""

    def __init__(self, params, cfg: U2NetConfig | None = None, *, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or U2NetConfig.u2netp()
        self.model = build_module(lambda: U2Net(self.cfg), params, "u2net", self.device,
                                  torch.float32, None)

    @torch.no_grad()
    def saliency(self, image: Image.Image) -> np.ndarray:
        """(MATTE_SIZE, MATTE_SIZE) float32: the min-max normalised saliency the matte is cut
        from."""
        small = np.asarray(image.convert("RGB").resize((MATTE_SIZE, MATTE_SIZE), Image.BILINEAR),
                           np.float32)
        x = torch.from_numpy(small[None]).to(self.device)
        mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        std = torch.as_tensor(IMAGENET_STD, device=self.device)
        x = ((x / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()
        pred = self.model(x)[0].cpu().numpy()
        lo, hi = float(pred.min()), float(pred.max())
        return (pred - lo) / (hi - lo + 1e-8)

    def __call__(self, image: Image.Image) -> Image.Image:
        rgb = image.convert("RGB")
        pred = self.saliency(rgb)
        alpha = Image.fromarray((pred >= 0.5).astype(np.uint8) * 255, "L")
        alpha = alpha.resize(rgb.size, Image.BILINEAR)
        rgba = np.dstack([np.asarray(rgb, np.uint8), np.asarray(alpha, np.uint8)])
        return Image.fromarray(rgba, "RGBA")


class ForegroundFeatureAveraging:
    """FFA with DINOv2-base at 336 px, in float32. ``params`` is the JAX DINO tree, bridged
    strictly; if None, the weights are random, drawn on the device from seed 0. ``matting`` is
    a ``PIL -> RGBA PIL`` callable, :func:`heuristic_matting` unless given."""

    def __init__(self, params=None, *, cfg: DinoConfig | None = None, matting=None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or DinoConfig.v2_base()
        self.matting = matting or heuristic_matting
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.model = build_module(lambda: Dino(self.cfg), params, "dino", self.device,
                                  torch.float32, gen)

    def preprocess(self, pil_image) -> np.ndarray:
        """Matting, the background zeroed, then a 336 x 336 bicubic resize: (1, 336, 336, 4)
        uint8 RGBA."""
        rgba = np.asarray(self.matting(pil_image), np.uint8).copy()
        rgba[rgba[..., 3] == 0] = 0
        img = Image.fromarray(rgba, "RGBA").resize((_SIZE, _SIZE), Image.BICUBIC)
        return np.asarray(img, np.uint8)[None]

    @staticmethod
    def _mask_from_rgb(rgb_sum: np.ndarray) -> np.ndarray:
        """The reference's foreground mask: background = the pixels at the channel sum's
        minimum; the mask resized bilinearly to the 24 x 24 grid and cut at 0.5; an empty mask
        becomes all ones."""
        mask = (rgb_sum != rgb_sum.min()).astype(np.uint8) * 255
        resized = np.asarray(Image.fromarray(mask).resize((_GRID, _GRID), Image.BILINEAR),
                             np.float32) / 255.0
        out = (resized > 0.5).astype(np.float32)
        if out.sum() == 0:
            out = np.ones_like(out)
        return out

    def _masks(self, rgb: np.ndarray) -> np.ndarray:
        """(B, 336, 336, 3) uint8 matted pixels -> (B, 24, 24) float32 foreground masks, on the
        host from the channel sum of the normalised pixels, as the reference sums its
        normalised tensor."""
        return np.stack([
            self._mask_from_rgb(((r / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).sum(-1))
            for r in rgb])

    @torch.no_grad()
    def _features_dispatch(self, rgba_batch: np.ndarray, variant: str,
                           raw_batch: np.ndarray | None = None) -> torch.Tensor:
        """The host's masks, then the masked mean patch token of each image, on the device."""
        rgb = rgba_batch[..., :3]
        masks = self._masks(rgb)
        if variant == "Crop-Feat":
            pixels = rgb
        elif variant == "Crop-Img":
            if raw_batch is None:
                raise ValueError("Crop-Img needs the un-matted pixels (raw_batch)")
            pixels = raw_batch
        else:
            raise ValueError(f"unknown variant: {variant}")
        x = to_device_normalized(np.ascontiguousarray(pixels), IMAGENET_MEAN, IMAGENET_STD,
                                 self.device)
        patches = self.model(x)["last_hidden_state"][:, 1:]
        grid = patches.reshape(patches.shape[0], _GRID, _GRID, -1)
        m = torch.from_numpy(masks).to(self.device)[..., None]
        return (grid * m).sum(dim=(1, 2)) / torch.clamp(m.sum(dim=(1, 2)), min=1e-6)

    def features(self, rgba_batch: np.ndarray, variant: str = "Crop-Feat",
                 raw_batch: np.ndarray | None = None) -> np.ndarray:
        """(B, 336, 336, 4) uint8 matted images -> (B, hidden) features; ``raw_batch`` holds
        the un-matted pixels of the Crop-Img variant."""
        return self._features_dispatch(rgba_batch, variant, raw_batch).float().cpu().numpy()

    def score_batch(self, variant: str, rgba_a, rgba_b, blocking: bool = True):
        fa = self._features_dispatch(np.asarray(rgba_a), variant)
        fb = self._features_dispatch(np.asarray(rgba_b), variant)

        def fetch():
            both = torch.stack([fa.float(), fb.float()]).cpu().numpy()
            return host_cosine(both[0], both[1])

        return fetch() if blocking else fetch

    def __call__(self, variant: str, images_a, images_b=None):
        """The reference's API: lists of PIL images."""
        rgba_a = np.concatenate([self.preprocess(i) for i in images_a])
        if images_b is None:
            return self.features(rgba_a, variant)
        rgba_b = np.concatenate([self.preprocess(i) for i in images_b])
        return float(self.score_batch(variant, rgba_a, rgba_b)[0])
