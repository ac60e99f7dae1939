"""Metric registry of the port: the ``--metric`` CLI surface mapped to scorer adapters
(counterpart of ``diffsim_tpu/metrics/registry.py``).

This slice ports the ``diffsim`` (SD-1.5) and ``diffsim_xl`` (SDXL) branches. Every other
metric, and the options that need an unported module (``--ip_adapter``, ``--use_mask``), raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

# metric -> the ROADMAP item (Queue 1) that ports it
NOT_PORTED = {
    "dit": "item 7 (the DiT scorer)",
    "diffeats": "item 4 (score_feats_batch, the OUTPUT taps)",
    **dict.fromkeys(("clip_i", "clip_cross", "clipfeats", "dino", "dinov1", "dino_cross",
                     "dinofeats", "cute", "lpips", "gram", "ensemble"),
                    "item 9 (the baseline metrics)"),
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md, Queue 1 "
                               f"{item})")


@dataclasses.dataclass
class MetricAdapter:
    """``score_pairs(pix_a (N, H, W, C), pix_b, prompts, blocking=True) -> (N,) scores``; with
    ``blocking=False`` it returns a zero-argument fetch, so the runner overlaps the next batch's
    host work with this batch's device work.

    ``score_triplets(pix_a, pix_b, pix_c, prompts, blocking=...) -> (s_ab, s_ac)`` is the
    fused 2AFC path (image A's work shared by both pairs). ``score_triplet_paths(paths_a,
    paths_b, paths_c, pix_a, pix_b, pix_c, prompts, blocking=..., loader=...)`` is its variant
    through the device moment cache, keyed by path; ``pix_*`` may be None. ``prewarm(paths_roles,
    loader)`` decodes the next chunk's cache misses on the loader's threads."""

    score_pairs: Callable[[np.ndarray, np.ndarray, list[str]], np.ndarray]
    lower_better: bool
    preprocess: Callable | None = None  # None => the default lanczos / [-1, 1] at image_size
    score_triplets: Callable | None = None
    score_triplet_paths: Callable | None = None
    prewarm: Callable | None = None
    scorer: object = None  # the scorer behind the adapter (its moment cache's stats)


def _make_prewarm(scorer):
    def prewarm(paths_roles, loader):
        from diffsim_tpu_torch.runtime.device_cache import prewarm_missing

        prewarm_missing(scorer._ensure_moment_cache(), paths_roles, loader)

    return prewarm


def _load_params(path):
    if not path:
        return None
    from diffsim_tpu_torch.convert.store import load_params

    return load_params(path)


def _load_tokenizer(path, pad_token: str = "<|endoftext|>"):
    if not path:
        return None
    from diffsim_tpu_torch.core.tokenizer import CLIPTokenizer

    return CLIPTokenizer.from_files(
        os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), pad_token)


def _require_tokenizer(args):
    """Converted weights with the HashTokenizer fallback give garbage prompt embeddings: refuse
    unless the caller opts in."""
    if (getattr(args, "weights", None) and not getattr(args, "tokenizer_dir", None)
            and not getattr(args, "allow_hash_tokenizer", False)):
        raise SystemExit(
            "--weights without --tokenizer_dir: prompt embeddings would be hash-tokenized "
            "garbage and every score meaningless. Pass --tokenizer_dir DIR (vocab.json + "
            "merges.txt), or --allow_hash_tokenizer to override for throughput runs.")


def _tiny_configs(name: str) -> dict:
    """The toy configs of ``--model_scale tiny`` (CPU tests), in float32."""
    from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
    from diffsim_tpu_torch.models.unet import UNetConfig
    from diffsim_tpu_torch.models.vae import VAEConfig

    kw = dict(vae_cfg=VAEConfig.tiny(), text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32)
    if name == "diffsim":
        return dict(unet_cfg=UNetConfig.tiny(), **kw)
    return dict(unet_cfg=UNetConfig.tiny_xl(cross_attention_dim=64),
                text2_cfg=CLIPTextConfig(vocab_size=1000, hidden=32, layers=2, heads=2,
                                         intermediate=64, projection_dim=16), **kw)


def build_metric(args, device=None) -> MetricAdapter:
    """The adapter for ``args.metric``. ``args`` carries the CLI surface (image_size,
    target_block/layer/step, similarity, seed, ...); ``device`` is the scoring device (None:
    the card)."""
    name = args.metric
    if name in NOT_PORTED:
        raise _not_ported(f"--metric {name}", NOT_PORTED[name])
    if name not in ("diffsim", "diffsim_xl"):
        raise ValueError(f"unknown metric: {name}")
    if getattr(args, "ip_adapter", False):
        raise _not_ported("--ip_adapter", "item 8 (IP-Adapter)")
    if getattr(args, "use_mask", False):
        raise _not_ported("--use_mask", "item 4 (mask-weighted queries)")
    similarity = args.similarity
    lower = similarity == "mse"
    _require_tokenizer(args)
    kw = _tiny_configs(name) if getattr(args, "model_scale", "full") == "tiny" else {}
    tokenizer = _load_tokenizer(getattr(args, "tokenizer_dir", None))
    params = _load_params(getattr(args, "weights", None))
    target = dict(target_block=args.target_block, target_layer=args.target_layer,
                  target_step=args.target_step, similarity=similarity, seed=args.seed)

    if name == "diffsim":
        from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15

        scorer = DiffSimSD15(params, img_size=args.image_size, device=device,
                             cfg_parity=getattr(args, "cfg_parity", True),
                             fast_softmax=getattr(args, "bf16_softmax", False),
                             tokenizer=tokenizer, **kw)
        target["text_attn"] = bool(getattr(args, "use_text_attn", False))
    else:
        from diffsim_tpu_torch.metrics.diffsim_xl import DiffSimXL

        scorer = DiffSimXL(params, img_size=args.image_size, device=device,
                           cfg_parity=getattr(args, "cfg_parity", True),
                           vae_fp32=not getattr(args, "xl_vae_bf16", False),
                           tokenizer=tokenizer, **kw)
    if getattr(args, "moment_cache_mb", None):
        scorer.moment_cache_mb = args.moment_cache_mb

    def score_pairs(pa, pb, prompts, blocking=True):
        return scorer.score_batch(pa, pb, prompt=prompts, blocking=blocking, **target)

    def score_triplets(pa, pb, pc, prompts, blocking=True):
        return scorer.score_triplet_batch(pa, pb, pc, prompt=prompts, blocking=blocking,
                                          **target)

    score_triplet_paths = prewarm = None
    if getattr(args, "device_cache", True):
        def score_triplet_paths(paths_a, paths_b, paths_c, pix_a=None, pix_b=None, pix_c=None,
                                prompts="", blocking=True, loader=None):
            return scorer.score_triplet_paths(paths_a, paths_b, paths_c, pix_a, pix_b, pix_c,
                                              loader=loader, prompt=prompts, blocking=blocking,
                                              **target)

        prewarm = _make_prewarm(scorer)

    from diffsim_tpu_torch.core.image import process_image_u8

    return MetricAdapter(score_pairs, lower,
                         preprocess=lambda img: process_image_u8(img, args.image_size),
                         score_triplets=score_triplets, score_triplet_paths=score_triplet_paths,
                         prewarm=prewarm, scorer=scorer)
