"""Host-side image loading and preprocessing (the port's own copy of the PIL path of
``diffsim_tpu/core/image.py``, with its threaded :class:`ImageLoader`, the CLIP and DINO
pipelines of the baseline metrics, their normalisation constants and the foreground masks of
``--use_mask``).

Parity-critical: images are resized with PIL lanczos and mapped to [-1, 1]. Arrays are NHWC,
the layout of the scorers' public functions.
"""

from __future__ import annotations

import collections
import concurrent.futures as _futures
import os
import threading
from typing import Sequence

import numpy as np
from PIL import Image

from diffsim_tpu_torch.runtime.profiling import span


CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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


def _shortest_side_resize(image: Image.Image, size: int, resample=Image.BICUBIC) -> Image.Image:
    """Resize so that the shorter side is ``size``, keeping the aspect ratio (the longer side
    truncated to an integer)."""
    w, h = image.size
    short, long = (w, h) if w <= h else (h, w)
    new_long = int(size * long / short)
    nw, nh = (size, new_long) if w <= h else (new_long, size)
    return image.resize((nw, nh), resample=resample)


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top:top + size, left:left + size]


def clip_preprocess_u8(image: Image.Image, size: int = 224) -> np.ndarray:
    """CLIP's resize and crop on the host, (1, size, size, 3) uint8; the mean / std
    normalisation runs on the device."""
    image = _shortest_side_resize(image.convert("RGB"), size)
    return _center_crop(np.asarray(image, np.uint8), size)[None]


def dino_preprocess_u8(image: Image.Image, resize: int = 256, crop: int = 224) -> np.ndarray:
    """DINO's shortest-side 256 bicubic resize and centre crop to 224, uint8."""
    image = _shortest_side_resize(image.convert("RGB"), resize)
    return _center_crop(np.asarray(image, np.uint8), crop)[None]


def clip_preprocess(image: Image.Image, size: int = 224) -> np.ndarray:
    """HF CLIPProcessor: shortest-side bicubic resize to ``size``, centre crop, 1/255, CLIP
    mean / std. (1, size, size, 3) float32."""
    image = _shortest_side_resize(image.convert("RGB"), size)
    arr = _center_crop(np.asarray(image, np.float32) / 255.0, size)
    return ((arr - CLIP_MEAN) / CLIP_STD)[None]


def dino_preprocess(image: Image.Image, resize: int = 256, crop: int = 224) -> np.ndarray:
    """DINO / DINOv2 (torchvision transforms, HF BitImageProcessor): shortest side 256 bicubic,
    centre crop 224, ImageNet mean / std. (1, crop, crop, 3) float32."""
    image = _shortest_side_resize(image.convert("RGB"), resize)
    arr = _center_crop(np.asarray(image, np.float32) / 255.0, crop)
    return ((arr - IMAGENET_MEAN) / IMAGENET_STD)[None]


class ImageLoader:
    """Threaded loader: decodes and resizes images on host threads while the card scores (PIL
    releases the GIL in decode and resize), with an LRU of preprocessed arrays keyed by
    ``(path, mtime_ns, size)``, so an image rewritten in place is decoded again.

    ``preprocess(pil_image) -> (1, H, W, C)`` replaces the default lanczos / [-1, 1] pipeline
    (the scorers' moment cache takes :func:`process_image_u8`). ``cache_mb`` is the LRU's
    budget (0 disables it); cached arrays are shared, so treat them as read-only.
    ``fast_decode`` asks libjpeg for a DCT-domain decode at >= img_size per side (not the
    reference pipeline: pixels differ slightly)."""

    def __init__(self, img_size: int = 512, num_workers: int | None = None, preprocess=None,
                 cache_mb: int = 512, fast_decode: bool = False):
        self.img_size = img_size
        self.fast_decode = fast_decode
        self._preprocess = preprocess or (lambda img: process_image(img, img_size))
        if num_workers is None:
            num_workers = min(32, (os.cpu_count() or 8))
        self._pool = _futures.ThreadPoolExecutor(max_workers=num_workers)
        self._cache: collections.OrderedDict[tuple, np.ndarray] = collections.OrderedDict()
        self._cache_bytes = 0
        self._cache_budget = int(cache_mb * 1e6)
        self._cache_lock = threading.Lock()

    def _key(self, path) -> tuple | None:
        if not isinstance(path, (str, os.PathLike)) or self._cache_budget <= 0:
            return None
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (os.fspath(path), st.st_mtime_ns, st.st_size)

    def _load(self, path) -> np.ndarray:
        key = self._key(path)
        if key is not None:
            with self._cache_lock:
                hit = self._cache.get(key)
                if hit is not None:
                    self._cache.move_to_end(key)
                    return hit
        with span("loader.decode"):
            arr = self._preprocess(load_image(path, self.img_size if self.fast_decode else None))
        if key is not None:
            with self._cache_lock:
                if key not in self._cache:
                    self._cache[key] = arr
                    self._cache_bytes += arr.nbytes
                    while self._cache_bytes > self._cache_budget and self._cache:
                        _, old = self._cache.popitem(last=False)
                        self._cache_bytes -= old.nbytes
        return arr

    def submit(self, path) -> _futures.Future:
        return self._pool.submit(self._load, path)

    def load_batch(self, paths: Sequence) -> np.ndarray:
        """Load a list of paths into one (N, H, W, C) array."""
        futs = [self.submit(p) for p in paths]
        return np.concatenate([f.result() for f in futs], axis=0)

    def close(self):
        self._pool.shutdown(wait=False)


def load_mask(path, img_size: int) -> np.ndarray:
    """Grayscale foreground mask -> (1, img_size, img_size) float32 in [0, 1]. Nearest-neighbour
    resize: masks are hard label maps, and interpolation would bleed the boundary before the
    dilation of ``metrics/readout.mask_to_latent``."""
    img = load_image(path).convert("L")
    img = img.resize((img_size, img_size), resample=Image.NEAREST)
    return (np.asarray(img, np.float32) / 255.0)[None]


def mask_from_matting(matting, path, img_size: int) -> np.ndarray:
    """A foreground mask made at score time: the alpha channel of ``matting(PIL RGB) -> PIL
    RGBA`` (``metrics/ffa.heuristic_matting`` or ``metrics/ffa.U2NetMatting``), resized nearest
    and binarised to (1, img_size, img_size) float32 in {0, 1}."""
    rgba = np.asarray(matting(load_image(path)), np.uint8)
    alpha = Image.fromarray(rgba[..., 3], "L").resize((img_size, img_size), Image.NEAREST)
    return (np.asarray(alpha, np.float32) > 127.5).astype(np.float32)[None]


def mask_path_for(image_path: str, image_root: str, mask_root: str) -> str:
    """The mask of an image: the same relative path under ``mask_root``, else the same stem
    with a .png extension."""
    rel = os.path.relpath(image_path, image_root)
    cand = os.path.join(mask_root, rel)
    if os.path.exists(cand):
        return cand
    alt = os.path.splitext(cand)[0] + ".png"
    if os.path.exists(alt):
        return alt
    raise FileNotFoundError(f"no mask for {image_path!r} under {mask_root!r} (tried {cand!r}, "
                            f"{alt!r})")
