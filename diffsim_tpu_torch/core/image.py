"""Host-side image loading and preprocessing (the port's own copy of the PIL path of
``diffsim_tpu/core/image.py``).

Parity-critical: images are resized with PIL lanczos and mapped to [-1, 1]. Arrays are NHWC,
the layout of the scorers' public functions.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_image(path_or_image, draft_size: int | None = None) -> Image.Image:
    """Open an image path (or pass through a PIL image). ``draft_size`` asks libjpeg for a
    DCT-domain decode at >= draft_size per side (a no-op for PNG)."""
    if isinstance(path_or_image, Image.Image):
        return path_or_image
    img = Image.open(path_or_image)
    if draft_size is not None:
        img.draft("RGB", (draft_size, draft_size))
    img.load()
    return img


def process_image(image: Image.Image, img_size: int = 512) -> np.ndarray:
    """RGB -> lanczos resize to (img_size, img_size) -> float32 [-1, 1] -> (1, H, W, 3)."""
    image = image.convert("RGB")
    image = image.resize((img_size, img_size), resample=Image.LANCZOS)
    arr = np.asarray(image, dtype=np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return arr[None, ...]


def process_image_u8(image: Image.Image, img_size: int = 512) -> np.ndarray:
    """RGB lanczos resize, (1, H, W, 3) uint8; the [-1, 1] mapping happens on the device."""
    image = image.convert("RGB")
    return np.asarray(image.resize((img_size, img_size), resample=Image.LANCZOS), np.uint8)[None]


def load_and_process(path, img_size: int = 512, fast_decode: bool = False) -> np.ndarray:
    return process_image(load_image(path, img_size if fast_decode else None), img_size)


def load_and_process_u8(path, img_size: int = 512, fast_decode: bool = False) -> np.ndarray:
    return process_image_u8(load_image(path, img_size if fast_decode else None), img_size)
