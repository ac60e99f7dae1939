"""ImageFolder-style training data for DiT (PIL and numpy only).

The port's own copy of ``diffsim_tpu/data/imagefolder.py``: one global shuffled stream, decoded
ahead on host threads. Preprocessing follows the published DiT recipe: progressive BOX
downsampling, a bicubic resize, a centre crop, a random horizontal flip, uint8 transport. The
shuffle and the flips come from separate seeded streams, so every process of a multi-process run
derives the same epoch order (``process_slice``). Unlike the JAX copy, a process draws the flips
of the whole global batch and keeps its slice's, so the slices of N processes are the batch of
one process, flips and all.
"""

from __future__ import annotations

import concurrent.futures as _futures
import os
import random

import numpy as np
from PIL import Image

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def center_crop_arr(image: Image.Image, image_size: int) -> np.ndarray:
    """The published ADM/DiT center-crop: halve with BOX while min side >= 2*target, bicubic
    to scale, center crop."""
    while min(*image.size) >= 2 * image_size:
        image = image.resize(tuple(x // 2 for x in image.size), resample=Image.BOX)
    scale = image_size / min(*image.size)
    image = image.resize(tuple(round(x * scale) for x in image.size), resample=Image.BICUBIC)
    arr = np.asarray(image.convert("RGB"), np.uint8)
    top = (arr.shape[0] - image_size) // 2
    left = (arr.shape[1] - image_size) // 2
    return arr[top : top + image_size, left : left + image_size]


class ImageFolderDataset:
    def __init__(self, root: str, image_size: int, seed: int = 0, hflip: bool = True,
                 num_workers: int | None = None):
        self.image_size = image_size
        self.hflip = hflip
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(cdir, f), self.class_to_idx[c]))
        self.seed = seed
        self._epoch = 0
        # flips come from a separate stream so they never perturb the order stream: every
        # process must derive the same shuffled epoch order from the shared seed while
        # consuming a different number of flip draws
        self._flip_rng = random.Random(f"{seed}-hflip")
        self._pool = _futures.ThreadPoolExecutor(max_workers=num_workers or min(32, os.cpu_count() or 8))

    def __len__(self):
        return len(self.samples)

    def _load(self, path: str, flip: bool) -> np.ndarray:
        with Image.open(path) as img:
            arr = center_crop_arr(img, self.image_size)
        if flip:
            arr = arr[:, ::-1]
        return arr

    def epoch_batches(self, batch: int, drop_last: bool = True, prefetch: int = 2,
                      process_slice: tuple[int, int] | None = None):
        """Yield (pixels_u8 (B,H,W,3), labels (B,)) with threaded decode-ahead.

        ``process_slice=(proc, nproc)``: every process derives the same global epoch order and
        flips (shared seed, per-epoch stream) but decodes only its contiguous batch/nproc slice
        of each global batch, as a DistributedSampler does."""
        order_rng = random.Random(f"{self.seed}-order-{self._epoch}")
        self._epoch += 1
        order = list(range(len(self.samples)))
        order_rng.shuffle(order)
        if drop_last:
            order = order[: len(order) - len(order) % batch]
        chunks = [order[i : i + batch] for i in range(0, len(order), batch)]
        keep = slice(None)
        if process_slice is not None:
            proc, nproc = process_slice
            if batch % nproc:
                raise ValueError(f"global batch {batch} must divide by process count {nproc}: "
                                 "a remainder would silently drop samples from every batch")
            local = batch // nproc
            keep = slice(proc * local, (proc + 1) * local)

        def submit(chunk):
            flips = [self.hflip and self._flip_rng.random() < 0.5 for _ in chunk]
            mine = list(zip(chunk, flips))[keep]
            futs = [self._pool.submit(self._load, self.samples[i][0], flip) for i, flip in mine]
            labels = np.asarray([self.samples[i][1] for i, _ in mine], np.int32)
            return futs, labels

        inflight = []
        ci = 0
        while ci < len(chunks) and len(inflight) <= prefetch:
            inflight.append(submit(chunks[ci]))
            ci += 1
        while inflight:
            futs, labels = inflight.pop(0)
            if ci < len(chunks):
                inflight.append(submit(chunks[ci]))
                ci += 1
            yield np.stack([f.result() for f in futs]), labels
