"""The CLIP baselines: clip_i (CLIP-I), clip_t, clip_cross and clipfeats, on PyTorch.

Counterpart of ``diffsim_tpu/metrics/clip_i.py``. ``clip_cross`` applies DiffSim's cross-image
attention readout inside CLIP's vision tower, at the reference hook's taps (Q/K/V projected from
the tap layer's input before its LayerNorm) with its out-projection replay
(``models/clip_vision.py``); ``clipfeats`` compares the tap layer's output states. The tower has
50 tokens at 224 px, so every attention takes the math path, as in JAX.

Scoring runs on ``cuda`` unless ``device`` is given; without a CUDA device and without a
``device`` the constructor raises. float32 by default, as the JAX scorer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from diffsim_tpu_torch.core.image import CLIP_MEAN, CLIP_STD, clip_preprocess_u8
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
from diffsim_tpu_torch.metrics.readout import _flat_cosine
from diffsim_tpu_torch.metrics.scorer_base import (
    build_module,
    fetchable,
    resolve_device,
    to_device_normalized,
    unit_cosine_100,
)
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.clip_vision import CLIPVision, CLIPVisionConfig, out_proj_replay
from diffsim_tpu_torch.ops.attention import sdpa


def resolve_layer(target_layer, what: str = "CLIP") -> int:
    """``target_layer`` as one index; a list or tuple must hold exactly one."""
    if isinstance(target_layer, (list, tuple)):
        if len(target_layer) != 1:
            raise ValueError(f"{what} metrics take a single target_layer")
        return int(target_layer[0])
    return int(target_layer)


def cross_readout(q, k, v, context=lambda ctx: ctx) -> torch.Tensor:
    """The baselines' cross-image attention readout of taps (2P, heads, S, D), A rows then B
    rows: the mean over both directions of the cosine between attn(Q_A, K_B, V_B) and
    attn(Q_A, K_A, V_A), each attention output passed through ``context`` first."""
    n = q.shape[0] // 2
    a, b = slice(0, n), slice(n, None)

    def attend(qs, ks):
        return context(sdpa(q[qs], k[ks], v[ks]))

    a_on_b, b_on_a = attend(a, b), attend(b, a)
    return (_flat_cosine(a_on_b, attend(a, a)) + _flat_cosine(b_on_a, attend(b, b))) / 2.0


class CLIPPair(nn.Module):
    """The CLIP vision and text towers: the JAX tree {'vision', 'text'} (bridge kind ``clip``)."""

    def __init__(self, vision_cfg: CLIPVisionConfig, text_cfg: CLIPTextConfig):
        super().__init__()
        self.vision = CLIPVision(vision_cfg)
        self.text = CLIPText(text_cfg)


class CLIPScore:
    """``params`` is the JAX tree {'vision', 'text'}, bridged strictly; if None, the weights are
    random, drawn on the device from seed 0. B/32 vision and the 512-wide text tower by default,
    in float32; prompts go through ``tokenizer`` (a hash tokenizer unless given)."""

    def __init__(self, params=None, *, vision_cfg: CLIPVisionConfig | None = None,
                 text_cfg: CLIPTextConfig | None = None, tokenizer=None, device=None):
        self.device = resolve_device(device)
        self.vision_cfg = vision_cfg or CLIPVisionConfig.b32()
        # CLIP-B/32's text tower: hidden 512, 8 heads, 12 layers
        self.text_cfg = text_cfg or CLIPTextConfig(hidden=512, heads=8, intermediate=2048,
                                                   projection_dim=512)
        self.tokenizer = tokenizer or HashTokenizer(self.text_cfg.vocab_size)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.model = build_module(lambda: CLIPPair(self.vision_cfg, self.text_cfg), params,
                                  "clip", self.device, torch.float32, gen)

    def preprocess(self, pil_image) -> np.ndarray:
        """Host side: resize and crop to uint8; the CLIP normalisation runs on the device."""
        return clip_preprocess_u8(pil_image, self.vision_cfg.image_size)

    def _pixels(self, *roles) -> torch.Tensor:
        pix = np.concatenate([np.asarray(r) for r in roles], axis=0)
        return to_device_normalized(pix, CLIP_MEAN, CLIP_STD, self.device)

    @torch.no_grad()
    def image_features(self, pixels: np.ndarray) -> np.ndarray:
        """(N, S, S, 3) -> (N, projection_dim) unit image embeddings."""
        emb = self.model.vision(self._pixels(pixels))["image_embeds"].float()
        return (emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)).cpu().numpy()

    @torch.no_grad()
    def text_features(self, texts, norm: bool = True) -> np.ndarray:
        ids = torch.from_numpy(np.asarray(self.tokenizer(texts))).long().to(self.device)
        emb = self.model.text.encode(ids)["text_embeds"].float().cpu().numpy()
        if norm:
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        return emb

    @torch.no_grad()
    def clipi_score_batch(self, pix_a, pix_b, blocking: bool = True):
        """100 x the cosine of the unit image embeddings, per pair."""
        out = self.model.vision(self._pixels(pix_a, pix_b))
        return fetchable(unit_cosine_100(out["image_embeds"]), blocking)

    def clipt_score_batch(self, texts, pix: np.ndarray) -> np.ndarray:
        return 100.0 * np.sum(self.text_features(texts) * self.image_features(pix), axis=-1)

    @torch.no_grad()
    def _cross(self, pix_a, pix_b, target_layer, capture: str) -> torch.Tensor:
        layer = resolve_layer(target_layer)
        vision = self.model.vision
        taps = vision.tap(self._pixels(pix_a, pix_b), layer, capture)
        if capture == "output":
            feats = taps["out"]
            n = feats.shape[0] // 2
            return _flat_cosine(feats[:n], feats[n:])
        # the reference's attention readout: SDPA, then the tap layer's out-projection replayed
        return cross_readout(taps["q"], taps["k"], taps["v"],
                             lambda ctx: out_proj_replay(vision, ctx, layer))

    def clip_cross_score_batch(self, pix_a, pix_b, target_layer, blocking: bool = True):
        return fetchable(self._cross(pix_a, pix_b, target_layer, "qkv"), blocking)

    def clip_feature_score_batch(self, pix_a, pix_b, target_layer, blocking: bool = True):
        return fetchable(self._cross(pix_a, pix_b, target_layer, "output"), blocking)

    # the reference's single-pair entry points

    def clipi_score(self, image_a, image_b) -> tuple[float, int]:
        s = self.clipi_score_batch(self.preprocess(image_a), self.preprocess(image_b))
        return float(s.sum()), len(s)

    def clip_cross_score(self, image_a, image_b, target_layer) -> float:
        return float(self.clip_cross_score_batch(self.preprocess(image_a),
                                                 self.preprocess(image_b), target_layer)[0])

    def clip_feature_score(self, image_a, image_b, target_layer) -> float:
        return float(self.clip_feature_score_batch(self.preprocess(image_a),
                                                   self.preprocess(image_b), target_layer)[0])
