"""Metric registry of the port: the ``--metric`` CLI surface mapped to scorer adapters
(counterpart of ``diffsim_tpu/metrics/registry.py``).

Every metric of the JAX registry: ``diffsim`` (SD-1.5, with ``--ip_adapter`` and
``--use_mask``), ``diffeats`` (SD-1.5's attn1 output features), ``diffsim_xl`` (SDXL, with
``--ip_adapter``), ``dit`` (DiT-XL/2) and the baselines (``clip_i``, ``clip_cross``,
``clipfeats``, ``dino``, ``dinov1``, ``dino_cross``, ``dinofeats``, ``cute``, ``lpips``,
``gram``). ``ensemble`` (diffsim, clip_i and dino voting) is assembled by ``cli/main.py`` from
three of these, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable

import numpy as np
import torch

from diffsim_tpu_torch.parallel import mesh

DIFFUSION = ("diffsim", "diffeats", "diffsim_xl", "dit")
BASELINES = ("clip_i", "clip_cross", "clipfeats", "dino", "dinov1", "dino_cross", "dinofeats",
             "cute", "lpips", "gram")
# the keyword arguments of a scoring call that hold one entry a row (``over_ranks``)
ROW_KEYS = ("prompt", "prompts", "mask_a", "mask_b", "pix_a", "pix_b", "pix_c")


@dataclasses.dataclass
class MetricAdapter:
    """``score_pairs(pix_a (N, H, W, C), pix_b, prompts, blocking=True) -> (N,) scores``; with
    ``blocking=False`` it returns a zero-argument fetch, so the runner overlaps the next batch's
    host work with this batch's device work.

    With ``wants_masks`` (``--use_mask`` on the SD-1.5 diffsim metric) ``score_pairs`` also takes
    ``mask_a`` / ``mask_b``, (N, H, W) foreground masks.

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
    wants_masks: bool = False  # --use_mask: score_pairs takes mask_a= / mask_b=


def _make_prewarm(scorer):
    def prewarm(paths_roles, loader):
        from diffsim_tpu_torch.runtime.device_cache import prewarm_missing

        prewarm_missing(scorer._ensure_moment_cache(), paths_roles, loader)

    return prewarm


def _load_params(path):
    """The ``--weights`` tree. The converters also write the VAE decoder (``vae_decoder``),
    which no scorer runs: it is dropped here (the DiT sampler reads it from its own file)."""
    if not path:
        return None
    from diffsim_tpu_torch.convert.store import load_params

    tree = load_params(path)
    tree.pop("vae_decoder", None)
    return tree


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


def _attach_ip(scorer, args, tiny: bool) -> None:
    """Attach the IP-Adapter as the CLI flags ask, at the reference's scale 0.5: the converted
    ``--ip_weights`` tree, else random weights. As in the JAX CLI, the image encoder is random
    either way (the converted tree holds no encoder). Tiny mode takes the tiny encoder and a
    tiny Resampler of the scorer's cross dim."""
    kw = {}
    if tiny:
        from diffsim_tpu_torch.models.clip_vision import CLIPVisionConfig
        from diffsim_tpu_torch.models.ip_adapter import ResamplerConfig

        kw = dict(encoder_cfg=CLIPVisionConfig.tiny(),
                  resampler_cfg=dataclasses.replace(
                      ResamplerConfig.tiny(), output_dim=scorer.unet_cfg.cross_attention_dim))
    converted = None
    if getattr(args, "ip_weights", None):
        from diffsim_tpu_torch.convert.store import load_params

        converted = load_params(args.ip_weights)
    scorer.enable_ip_adapter(converted, scale=0.5, **kw)


def _tiny_configs(name: str, image_size: int = 32) -> dict:
    """The toy configs of ``--model_scale tiny`` (CPU tests), in float32; the tiny DiT's latent
    grid follows ``image_size`` (the tiny VAE downsamples by 2). As in JAX, LPIPS and VGG-Gram
    keep their VGG at full width, and FFA's tiny DINO takes patch 14 (the 24 x 24 grid at
    336 px)."""
    from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
    from diffsim_tpu_torch.models.unet import UNetConfig
    from diffsim_tpu_torch.models.vae import VAEConfig

    if name in ("clip_i", "clip_cross", "clipfeats"):
        from diffsim_tpu_torch.models.clip_vision import CLIPVisionConfig

        return dict(vision_cfg=CLIPVisionConfig.tiny(), text_cfg=CLIPTextConfig.tiny())
    if name in ("dino", "dinov1", "dino_cross", "dinofeats", "cute"):
        from diffsim_tpu_torch.models.dinov2 import DinoConfig

        cfg = DinoConfig.tiny()
        return dict(cfg=dataclasses.replace(cfg, patch=14) if name == "cute" else cfg)
    if name in ("lpips", "gram"):
        return {}
    if name == "dit":
        from diffsim_tpu_torch.models.dit import DiTConfig

        return dict(dit_cfg=DiTConfig.tiny(input_size=image_size // 2, num_classes=1000),
                    vae_cfg=VAEConfig.tiny(), dtype=torch.float32)
    kw = dict(vae_cfg=VAEConfig.tiny(), text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32)
    if name in ("diffsim", "diffeats"):
        return dict(unet_cfg=UNetConfig.tiny(), **kw)
    return dict(unet_cfg=UNetConfig.tiny_xl(cross_attention_dim=64),
                text2_cfg=CLIPTextConfig(vocab_size=1000, hidden=32, layers=2, heads=2,
                                         intermediate=64, projection_dim=16), **kw)


def build_metric(args, device=None) -> MetricAdapter:
    """The adapter for ``args.metric``. ``args`` carries the CLI surface (image_size,
    target_block/layer/step, similarity, seed, ...); ``device`` is the scoring device (None:
    this rank's card). In a process group of several ranks every rank must hold the same
    weights (checked here), and each call's pairs or triplets shard over the ranks
    (:func:`_over_ranks`)."""
    adapter = _baseline(args, device) if args.metric in BASELINES else _diffusion(args, device)
    if mesh.world()[1] == 1:
        return adapter
    mesh.check_same_weights(adapter.scorer, f"--metric {args.metric}")
    return _over_ranks(adapter, guard_pairs=args.metric in DIFFUSION)


def _over_ranks(adapter: MetricAdapter, guard_pairs: bool = False) -> MetricAdapter:
    """The adapter with every scoring path run on this rank's rows of each call and the scores
    all-gathered (:func:`over_ranks`); ``prewarm`` decodes only this rank's rows'
    misses. A pair's score does not depend on the rank that scores it: each call seeds one
    generator and shares every draw across the batch (``core/prng.py``).

    ``guard_pairs`` (the DiffSim adapters; the baselines have no guard, as in JAX): every rank
    runs ``hbm_guard.check_pairs`` on the call's largest block, ceil(n / size) pairs, before it
    scores its own, so an over-budget call raises ``HbmBudgetError`` on every rank alike, before
    any rank uploads a byte or enters the gather. The check inside ``score_batch`` stays for
    callers outside a group."""

    def sharded(fn, parts, check=None):
        return None if fn is None else over_ranks(fn, parts, check)

    pair_check = None
    if guard_pairs:
        from diffsim_tpu_torch.runtime import hbm_guard

        def pair_check(block):
            hbm_guard.check_pairs(adapter.scorer, block)

    prewarm = None
    if adapter.prewarm is not None:
        def prewarm(paths_roles, loader):
            sl = mesh.shard_rows(len(paths_roles[0]))
            adapter.prewarm([role[sl] for role in paths_roles], loader)

    return dataclasses.replace(
        adapter, score_pairs=sharded(adapter.score_pairs, 1, pair_check),
        score_triplets=sharded(adapter.score_triplets, 2),
        score_triplet_paths=sharded(adapter.score_triplet_paths, 2), prewarm=prewarm)


def over_ranks(fn, parts: int = 1, check=None):
    """``fn(*rows, blocking=True, **kw)`` run on this rank's rows of every call
    (``mesh.shard_rows``), its scores all-gathered back into the call's order
    (``mesh.gather_rows``). Every positional argument, and each keyword in ``ROW_KEYS``, holds
    one entry a row (None and a single prompt string are shared by every row); ``fn`` returns
    ``parts`` (N,) score arrays (one array, or a tuple of two), or with ``blocking=False`` a
    zero-argument fetch of them. With ``blocking=False`` the wrapper returns a fetch too, and
    the gather runs inside it, so a caller's one batch in flight still overlaps the next batch's
    host work. A rank whose block is empty calls nothing and joins the gather. Every rank must
    make the same calls in the same order. ``check(block)``, where given, runs first on every
    rank with the call's largest block, ceil(n / size) rows, so that what it raises, it raises
    on every rank.

    ``wrapped.rows`` counts the rows this rank scored."""

    def rows_of(value, sl):
        return value if value is None or isinstance(value, str) else value[sl]

    @functools.wraps(fn)
    def wrapped(*args, blocking=True, **kw):
        n = len(args[0])
        if check is not None and n:
            check(-(-n // mesh.world()[1]))
        sl = mesh.shard_rows(n)
        local = None
        if sl.stop > sl.start:
            local = fn(*(rows_of(a, sl) for a in args), blocking=False,
                       **{k: rows_of(v, sl) if k in ROW_KEYS else v for k, v in kw.items()})
            wrapped.rows += sl.stop - sl.start

        def fetch():
            got = local() if callable(local) else local
            if got is None:
                got = (np.zeros(0, np.float32),) * parts
            elif parts == 1:
                got = (got,)
            full = [mesh.gather_rows(torch.from_numpy(np.ascontiguousarray(g, np.float32)), n)
                    .numpy() for g in got]
            return full[0] if parts == 1 else tuple(full)

        return fetch() if blocking else fetch

    wrapped.rows = 0
    return wrapped


def _diffusion(args, device) -> MetricAdapter:
    """The adapter of a DiffSim metric (SD-1.5, SDXL, DiT) or ``diffeats``."""
    name = args.metric
    if name not in DIFFUSION:
        raise ValueError(f"unknown metric: {name}")
    similarity = args.similarity
    lower = similarity == "mse"
    tokenizer = None
    if name != "dit":  # DiT is class-conditioned: no prompt to tokenize
        _require_tokenizer(args)
        tokenizer = _load_tokenizer(getattr(args, "tokenizer_dir", None))
    tiny = getattr(args, "model_scale", "full") == "tiny"
    kw = _tiny_configs(name, args.image_size) if tiny else {}
    params = _load_params(getattr(args, "weights", None))
    target = dict(target_block=args.target_block, target_layer=args.target_layer,
                  target_step=args.target_step, similarity=similarity, seed=args.seed)

    ip_adapter = bool(getattr(args, "ip_adapter", False)) and name in ("diffsim", "diffsim_xl")
    if name == "dit":
        from diffsim_tpu_torch.metrics.diffsim_dit import DiffSimDiT

        # the scorer ignores the prompts and target_block, as the JAX scorer does
        scorer = DiffSimDiT(params, img_size=args.image_size, device=device, **kw)
    elif name in ("diffsim", "diffeats"):
        from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15

        scorer = DiffSimSD15(params, img_size=args.image_size, device=device,
                             cfg_parity=getattr(args, "cfg_parity", True),
                             fast_softmax=getattr(args, "bf16_softmax", False),
                             tokenizer=tokenizer, **kw)
        if name == "diffsim":
            target["text_attn"] = bool(getattr(args, "use_text_attn", False))
    else:
        from diffsim_tpu_torch.metrics.diffsim_xl import DiffSimXL

        scorer = DiffSimXL(params, img_size=args.image_size, device=device,
                           cfg_parity=getattr(args, "cfg_parity", True),
                           vae_fp32=not getattr(args, "xl_vae_bf16", False),
                           tokenizer=tokenizer, **kw)
    if ip_adapter:
        _attach_ip(scorer, args, tiny)
    if getattr(args, "moment_cache_mb", None):
        scorer.moment_cache_mb = args.moment_cache_mb

    from diffsim_tpu_torch.core.image import process_image_u8

    def preprocess(img):
        return process_image_u8(img, args.image_size)

    if name == "diffeats":
        def score_feats(pa, pb, prompts, blocking=True):
            return scorer.score_feats_batch(pa, pb, prompt=prompts, blocking=blocking, **target)

        return MetricAdapter(score_feats, lower, preprocess=preprocess, scorer=scorer)

    pair_kw = {"ip_adapter": True} if ip_adapter else {}
    wants_masks = name == "diffsim" and bool(getattr(args, "use_mask", False))

    def score_pairs(pa, pb, prompts, blocking=True, **masks):
        return scorer.score_batch(pa, pb, prompt=prompts, blocking=blocking, **target,
                                  **pair_kw, **masks)

    if ip_adapter:  # the triplet paths have no IP-Adapter taps
        return MetricAdapter(score_pairs, lower, preprocess=preprocess, scorer=scorer,
                             wants_masks=wants_masks)

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

    return MetricAdapter(score_pairs, lower, preprocess=preprocess,
                         score_triplets=score_triplets, score_triplet_paths=score_triplet_paths,
                         prewarm=prewarm, scorer=scorer, wants_masks=wants_masks)


def _baseline(args, device) -> MetricAdapter:
    """The adapter of a baseline metric. Each scores pairs only (no triplet path), with its
    scorer's host preprocessing where the JAX adapter has one (LPIPS and VGG-Gram take the
    default lanczos / [-1, 1] pixels, as in JAX)."""
    name = args.metric
    tiny = getattr(args, "model_scale", "full") == "tiny"
    kw = _tiny_configs(name) if tiny else {}
    params = _load_params(getattr(args, "weights", None))
    if name in ("clip_i", "clip_cross", "clipfeats"):
        from diffsim_tpu_torch.metrics.clip_i import CLIPScore

        scorer = CLIPScore(params, device=device, **kw)
        method = {"clip_i": scorer.clipi_score_batch, "clip_cross": scorer.clip_cross_score_batch,
                  "clipfeats": scorer.clip_feature_score_batch}[name]
    elif name in ("dino", "dinov1", "dino_cross", "dinofeats"):
        from diffsim_tpu_torch.metrics.dino import DinoScore, Dinov2Score

        scorer = (DinoScore if name == "dinov1" else Dinov2Score)(params, device=device, **kw)
        method = {"dino_cross": scorer.dino_cross_score_batch,
                  "dinofeats": scorer.dino_feature_score_batch}.get(name, scorer.dino_score_batch)
    elif name == "cute":
        from diffsim_tpu_torch.metrics.ffa import ForegroundFeatureAveraging, U2NetMatting

        matting = None
        if getattr(args, "matting_weights", None):
            matting = U2NetMatting(_load_params(args.matting_weights), device=device)
        scorer = ForegroundFeatureAveraging(params, matting=matting, device=device, **kw)
        method = functools.partial(scorer.score_batch, "Crop-Feat")
    elif name == "lpips":
        from diffsim_tpu_torch.metrics.lpips import LPIPS

        scorer = LPIPS(params, device=device)
        method = scorer.score_batch
    else:
        from diffsim_tpu_torch.metrics.vgg_gram import VGGGram

        scorer = VGGGram(params, device=device)
        method = scorer.score_batch
    layer = (args.target_layer,) if name in ("clip_cross", "clipfeats", "dino_cross",
                                              "dinofeats") else ()

    def score_pairs(pa, pb, prompts, blocking=True):
        return method(pa, pb, *layer, blocking=blocking)

    preprocess = None if name in ("lpips", "gram") else scorer.preprocess
    return MetricAdapter(score_pairs, name == "lpips", preprocess=preprocess, scorer=scorer)
