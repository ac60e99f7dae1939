"""The VGG-Gram style baseline, on PyTorch.

Counterpart of ``diffsim_tpu/metrics/vgg_gram.py``, with the reference's two quirks: the
preprocessing resizes the *shortest* side to ``img_size`` with no crop, so images keep their
aspect ratio and batches may be ragged; and the score is the cosine of the **last row** of each
image's conv5_1 Gram matrix, not of the whole matrix. A ragged batch is scored in one bucket per
image shape; every bucket is dispatched before any is fetched, so ``blocking=False`` overlaps
the whole batch with the caller's host work. VGG-19 runs on cuDNN with PyTorch's defaults (TF32
allowed on the card).
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from diffsim_tpu_torch.core.image import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    _shortest_side_resize,
    load_image,
)
from diffsim_tpu_torch.metrics.scorer_base import (
    build_module,
    host_cosine,
    resolve_device,
    to_device_normalized,
)
from diffsim_tpu_torch.models.vgg import VGG, VGG19_CFG, VGG19_CONV5_1


class VGGGram:
    """``params`` is the JAX VGG-19 tree {'convs'}, bridged strictly; if None, the weights are
    random, drawn on the device from seed 0. Float32."""

    def __init__(self, params=None, *, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.model = build_module(lambda: VGG(VGG19_CFG), params, "vgg", self.device,
                                  torch.float32, gen)

    def preprocess(self, pil_image, img_size: int = 512) -> np.ndarray:
        """torchvision's ``Resize(img_size)`` (shortest side, bilinear), uint8 out; the ImageNet
        normalisation runs on the device."""
        img = _shortest_side_resize(pil_image.convert("RGB"), img_size, resample=Image.BILINEAR)
        return np.asarray(img, np.uint8)[None]

    @torch.no_grad()
    def _gram_rows(self, pix: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) of one shape -> (B, 512): the last row of each conv5_1 Gram matrix."""
        x = to_device_normalized(pix, IMAGENET_MEAN, IMAGENET_STD, self.device)
        _, taps = self.model.features(x, (VGG19_CONV5_1,))
        f = taps[VGG19_CONV5_1]
        m = f.reshape(f.shape[0], f.shape[1], -1).float()  # (B, 512, h w)
        return torch.einsum("bh,beh->be", m[:, -1], m)

    def _rows_dispatch(self, pix) -> torch.Tensor:
        """Gram rows of a stacked array, or of a ragged list of (H, W, 3) / (1, H, W, 3) arrays
        in one bucket per shape, on the device in the input's order."""
        if isinstance(pix, np.ndarray):
            return self._gram_rows(pix)
        items = [p[None] if p.ndim == 3 else p for p in map(np.asarray, pix)]
        buckets: dict[tuple, list[int]] = {}
        for i, p in enumerate(items):
            buckets.setdefault(p.shape[1:], []).append(i)
        rows, order = [], []
        for idx in buckets.values():
            rows.append(self._gram_rows(np.concatenate([items[i] for i in idx])))
            order.extend(idx)
        inverse = torch.empty(len(order), dtype=torch.long)
        inverse[torch.tensor(order)] = torch.arange(len(order))
        return torch.cat(rows)[inverse.to(self.device)]

    def score_batch(self, pix_a, pix_b, blocking: bool = True):
        """Cosine of the conv5_1 Gram last rows per pair; stacked arrays or ragged lists."""
        rows_a, rows_b = self._rows_dispatch(pix_a), self._rows_dispatch(pix_b)

        def fetch():
            both = torch.stack([rows_a, rows_b]).cpu().numpy()
            return host_cosine(both[0], both[1])

        return fetch() if blocking else fetch

    def gram_similarity(self, image_a_path, image_b_path, img_size: int = 512) -> float:
        pa = self.preprocess(load_image(image_a_path), img_size)
        pb = self.preprocess(load_image(image_b_path), img_size)
        return float(self.score_batch(pa, pb)[0])
