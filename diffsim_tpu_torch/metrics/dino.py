"""The DINO baselines: dino (DINOv2 CLS cosine), dinov1 (DINO ViT-S/8), dino_cross and
dinofeats, on PyTorch.

Counterpart of ``diffsim_tpu/metrics/dino.py``. The cross readout is softmax attention on the
un-merged (B, heads, S, D) context with no out-projection: four plain ``sdpa`` calls (257 or 785
tokens: the math path, as in JAX) reduced by the port's float64 flat cosine. ``dinofeats``
compares the attention submodule's merged context at the tap layer.

Scoring runs on ``cuda`` unless ``device`` is given; without a CUDA device and without a
``device`` the constructor raises. float32 by default, as the JAX scorer.
"""

from __future__ import annotations

import numpy as np
import torch

from diffsim_tpu_torch.core.image import IMAGENET_MEAN, IMAGENET_STD, dino_preprocess_u8
from diffsim_tpu_torch.metrics.clip_i import cross_readout, resolve_layer
from diffsim_tpu_torch.metrics.readout import _flat_cosine
from diffsim_tpu_torch.metrics.scorer_base import (
    build_module,
    fetchable,
    resolve_device,
    to_device_normalized,
    unit_cosine_100,
)
from diffsim_tpu_torch.models.dinov2 import Dino, DinoConfig


class Dinov2Score:
    """HF facebook/dinov2-small by default. ``params`` is the JAX package's DINO tree, bridged
    strictly; if None, the weights are random, drawn on the device from seed 0. Float32."""

    cfg_factory = staticmethod(DinoConfig.v2_small)

    def __init__(self, params=None, *, cfg: DinoConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or self.cfg_factory()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.model = build_module(lambda: Dino(self.cfg), params, "dino", self.device,
                                  torch.float32, gen)

    def preprocess(self, pil_image) -> np.ndarray:
        return dino_preprocess_u8(pil_image)

    def _pixels(self, *roles) -> torch.Tensor:
        pix = np.concatenate([np.asarray(r) for r in roles], axis=0)
        return to_device_normalized(pix, IMAGENET_MEAN, IMAGENET_STD, self.device)

    @torch.no_grad()
    def image_features(self, pixels: np.ndarray) -> np.ndarray:
        """(N, 224, 224, 3) -> (N, hidden) unit CLS embeddings."""
        emb = self.model(self._pixels(pixels))["cls"].float()
        return (emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)).cpu().numpy()

    @torch.no_grad()
    def dino_score_batch(self, pix_a, pix_b, blocking: bool = True):
        """100 x the cosine of the unit CLS embeddings, per pair."""
        cls = self.model(self._pixels(pix_a, pix_b))["cls"]
        return fetchable(unit_cosine_100(cls), blocking)

    @torch.no_grad()
    def _cross(self, pix_a, pix_b, target_layer, capture: str) -> torch.Tensor:
        taps = self.model.tap(self._pixels(pix_a, pix_b), resolve_layer(target_layer, "DINO"),
                              capture)
        if capture == "output":
            feats = taps["out"]
            n = feats.shape[0] // 2
            return _flat_cosine(feats[:n], feats[n:])
        return cross_readout(taps["q"], taps["k"], taps["v"])

    def dino_cross_score_batch(self, pix_a, pix_b, target_layer, blocking: bool = True):
        return fetchable(self._cross(pix_a, pix_b, target_layer, "qkv"), blocking)

    def dino_feature_score_batch(self, pix_a, pix_b, target_layer, blocking: bool = True):
        return fetchable(self._cross(pix_a, pix_b, target_layer, "output"), blocking)

    # the reference's single-pair entry points

    def dino_score(self, image_a, image_b) -> tuple[float, int]:
        s = self.dino_score_batch(self.preprocess(image_a), self.preprocess(image_b))
        return float(s.sum()), len(s)

    def dino_cross_score(self, image_a, image_b, target_layer) -> float:
        return float(self.dino_cross_score_batch(self.preprocess(image_a),
                                                 self.preprocess(image_b), target_layer)[0])

    def dino_feature_score(self, image_a, image_b, target_layer) -> float:
        return float(self.dino_feature_score_batch(self.preprocess(image_a),
                                                   self.preprocess(image_b), target_layer)[0])


class DinoScore(Dinov2Score):
    """DINO v1 ViT-S/8 (torch.hub dino_vits8): 785 tokens at 224 px."""

    cfg_factory = staticmethod(DinoConfig.v1_vits8)
