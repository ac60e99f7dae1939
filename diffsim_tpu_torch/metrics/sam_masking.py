"""Score-time masks from SAM, on PyTorch: ``--use_mask --sam_weights``.

Counterpart of ``diffsim_tpu/metrics/sam_masking.py``. A centre-point prompt segments the
dominant object and the best-IoU mask becomes the alpha channel, so SAM plugs into the matting
interface of ``metrics/ffa.U2NetMatting`` and ``heuristic_matting``
(``core/image.mask_from_matting``). The host steps follow the published predictor, in the JAX
order: resize the longest side to ``cfg.image_size`` (bilinear), normalise, zero-pad bottom and
right; the mask logits (image_size / 4) are un-padded, resized as floats (bilinear) to the
original size, and only then cut at 0.

The network runs in float32 on ``cuda`` unless ``device`` is given; without a CUDA device and
without a ``device`` the constructor raises. One mask at a time is on the device: the runner
calls the matting from its mask threads, and at 1024 px a global layer of ViT-H holds 1.07 GB of
logits and as much again of probabilities.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from PIL import Image

from diffsim_tpu_torch.metrics.scorer_base import build_module, resolve_device
from diffsim_tpu_torch.models import sam


def infer_config(params) -> sam.SamConfig:
    """Recover the SamConfig from a converted tree: encoder width/depth from the blocks,
    encoder heads from the stored rel-pos head_dim, the global-attention layer set and
    window size from the rel-pos table lengths (windowed blocks store (2*window-1)-row
    tables, global blocks (2*grid-1)). decoder_heads is not recoverable from shapes and is
    fixed at the published 8 (all sam_vit_* checkpoints)."""
    enc = params["image_encoder"]
    grid = np.asarray(enc["pos_embed"]).shape[0]
    dim = np.asarray(enc["pos_embed"]).shape[-1]
    patch = np.asarray(enc["patch_embed"]["w"]).shape[0]
    blocks = enc["blocks"]
    # rel-pos tables are (2*size-1, head_dim): head count falls out of the stored head_dim
    heads = dim // np.asarray(blocks[0]["attn"]["rel_pos_h"]).shape[1]
    global_attn = tuple(
        i for i, b in enumerate(blocks)
        if np.asarray(b["attn"]["rel_pos_h"]).shape[0] == 2 * grid - 1
    )
    win_rows = [np.asarray(b["attn"]["rel_pos_h"]).shape[0]
                for i, b in enumerate(blocks) if i not in global_attn]
    window = (win_rows[0] + 1) // 2 if win_rows else grid
    pd = np.asarray(params["prompt_encoder"]["no_mask"]).shape[0]
    n_tok = np.asarray(params["mask_decoder"]["mask_tokens"]).shape[0]
    mlp = np.asarray(params["mask_decoder"]["layers"][0]["mlp"]["fc1"]["w"]).shape[1]
    return sam.SamConfig(
        image_size=grid * patch, patch=patch, encoder_dim=dim, encoder_depth=len(blocks),
        encoder_heads=heads, global_attn=global_attn, window=window, prompt_dim=pd,
        decoder_heads=8, decoder_depth=len(params["mask_decoder"]["layers"]),
        decoder_mlp=mlp, num_mask_tokens=n_tok,
    )


class SamMasking:
    """``PIL image -> RGBA PIL`` matting by SAM's centre-point prompt. ``params`` is the JAX SAM
    tree (``cli.convert sam``), bridged strictly, its config inferred unless ``cfg`` is given;
    if None, the weights are random, drawn on the device from seed 0, and ``cfg`` is needed."""

    def __init__(self, params, cfg: sam.SamConfig | None = None, *, device=None):
        self.device = resolve_device(device)
        if params is None and cfg is None:
            raise ValueError("SamMasking: random weights need a cfg")
        self.cfg = cfg or infer_config(params)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.model = build_module(lambda: sam.Sam(self.cfg), params, "sam", self.device,
                                  torch.float32, gen)
        self._lock = threading.Lock()

    def inputs(self, image: Image.Image):
        """The predictor's host steps: (pixels (1, S, S, 3) float32, SAM-normalised and
        zero-padded; coords (1, 1, 2) of the centre point in resized pixels; labels (1, 1);
        the resized (width, height))."""
        image = image.convert("RGB")
        w, h = image.size
        size = self.cfg.image_size
        scale = size / max(w, h)
        nw, nh = max(1, int(round(w * scale))), max(1, int(round(h * scale)))
        resized = np.asarray(image.resize((nw, nh), Image.BILINEAR), np.float32)
        # normalise first, then pad: the pad pixels are exactly 0 in normalised space
        resized = ((resized - np.asarray(sam.PIXEL_MEAN, np.float32))
                   / np.asarray(sam.PIXEL_STD, np.float32))
        pixels = np.zeros((1, size, size, 3), np.float32)
        pixels[0, :nh, :nw] = resized
        coords = np.asarray([[[nw / 2.0, nh / 2.0]]], np.float32)
        labels = np.asarray([[1]], np.int64)
        return pixels, coords, labels, (nw, nh)

    @torch.no_grad()
    def best_logits(self, pixels, coords, labels) -> np.ndarray:
        """(S / 4, S / 4) mask logits of the best-IoU multimask output."""
        with self._lock:
            masks, iou = self.model.predict(
                torch.from_numpy(pixels).to(self.device),
                torch.from_numpy(coords).to(self.device),
                torch.from_numpy(labels).to(self.device))
            best = iou.argmax(dim=1)
            return masks[torch.arange(masks.shape[0]), best][0].cpu().numpy()

    def __call__(self, image: Image.Image) -> Image.Image:
        rgb = image.convert("RGB")
        pixels, coords, labels, resized = self.inputs(rgb)
        logits = resampled_logits(self.best_logits(pixels, coords, labels), self.cfg, resized,
                                  rgb.size)
        alpha = (logits > 0).astype(np.uint8) * 255
        return Image.fromarray(np.dstack([np.asarray(rgb, np.uint8), alpha]), "RGBA")


def resampled_logits(logits: np.ndarray, cfg: sam.SamConfig, resized: tuple,
                     size: tuple) -> np.ndarray:
    """(h, w) float32 logits at the original ``size`` (w, h): the (S / 4, S / 4) logits of the
    ``resized`` (w, h) image un-padded and resized as floats (bilinear). The mask is where they
    are above 0: the published predictor resamples, then thresholds."""
    q = logits.shape[0] / cfg.image_size  # = 1/4
    nw, nh = resized
    crop = logits[: max(1, int(round(nh * q))), : max(1, int(round(nw * q)))]
    return np.asarray(Image.fromarray(crop.astype(np.float32), "F").resize(size, Image.BILINEAR))
