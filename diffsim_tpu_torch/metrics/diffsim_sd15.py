"""DiffSim scorer, SD-1.5 backbone, on PyTorch and CUDA.

Counterpart of ``diffsim_tpu/metrics/diffsim_sd15.py``, with the same public layouts: pixels
are NHWC (P, H, W, 3) uint8 or float in [-1, 1], taps (B, heads, S, D), ``noise_override`` is
``(eps_vae, eps_noise)``, each (2, h, w, 4). The graph per call:

    pixels -> VAE encode -> posterior sample -> q_sample to t -> UNet over the CFG-doubled
    batch [uncond_a, cond_a, uncond_b, cond_b], stopping at the tap -> cross/self attention
    readout -> (P,) scores

Scoring runs on ``cuda`` unless ``device`` is given; without a CUDA device and without a
``device`` the constructor raises. Default dtype bf16, as in the JAX scorer.

``score_triplet_paths`` scores triplets of image paths through the device moment cache
(``runtime/device_cache.py``): each unique image is decoded and VAE-encoded once. It and
``score_triplet_batch`` share one tail (moments -> scores), so an all-hit rescore repeats its
scores bit for bit and cached moments score as fresh ones do.

The pair path also takes the IP-Adapter taps (``ip_adapter=True``: attn2's image keys and values,
the adapter tokens made from the scored images themselves) and mask-weighted queries
(``mask_a`` / ``mask_b``); ``score_feats_batch`` is the ``diffeats`` readout of attn1's output,
and ``tap_values`` gives one image's Q/K/V.
"""

from __future__ import annotations

import numpy as np
import torch

from diffsim_tpu_torch.core import schedulers
from diffsim_tpu_torch.core.image import load_and_process
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
from diffsim_tpu_torch.metrics import readout
from diffsim_tpu_torch.metrics.scorer_base import (
    IPAdapterMixin,
    build_module,
    fetchable,
    moment_cache,
    pair_score,
    per_item,
    pool_moments,
    resolve_device,
    role_noise,
    triplet_prompts,
    triplet_scores,
    to_device_pixels,
)
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.ip_adapter import ResamplerConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig, encode_chunked, sample_latents
from diffsim_tpu_torch.ops.attention import fast_softmax as fast_softmax_mode
from diffsim_tpu_torch.ops.taps import IP_QKV, OUTPUT, QKV, TapSpec
from diffsim_tpu_torch.runtime import hbm_guard


def sd15_tap(target_block: str, target_layer, ip_adapter: bool = False,
             fix_layer_collapse: bool = False, text_attn: bool = False) -> TapSpec:
    """The reference CLI addressing -> an absolute TapSpec (``diffsim_tpu`` ``sd15_tap``).

    A length-1 ``target_layer`` list collapses to layer 0 (the reference's quirk, kept by
    default; ``fix_layer_collapse=True`` unwraps it). Down taps address absolute down block L,
    up taps absolute up block L + 1, always ``attentions[-1].transformer_blocks[-1]``;
    ``text_attn`` taps the text cross-attention (attn2) instead of attn1, and ``ip_adapter``
    attn2's IP-Adapter keys and values (IP_QKV)."""
    if isinstance(target_layer, (list, tuple)):
        if len(target_layer) == 1:
            target_layer = target_layer[0] if fix_layer_collapse else 0
        else:
            raise ValueError("SD-1.5 takes a single target_layer index")
    attn = "attn2" if (ip_adapter or text_attn) else "attn1"
    capture = IP_QKV if ip_adapter else QKV
    if target_block == "down_blocks":
        return TapSpec("down", (int(target_layer), -1, -1), attn, capture)
    if target_block == "mid_blocks":
        return TapSpec("mid", (0, -1, -1), attn, capture)
    if target_block == "up_blocks":
        return TapSpec("up", (int(target_layer) + 1, -1, -1), attn, capture)
    raise ValueError(f"unknown target_block: {target_block}")


class DiffSimSD15(IPAdapterMixin):
    """Batched SD-1.5 DiffSim. ``params`` is the JAX package's parameter tree
    {'unet', 'vae' (encoder), 'text'} as numpy arrays, bridged strictly; if None, the weights
    are random, drawn on the device from ``torch.Generator`` seeded with ``init_seed``
    (throughput and tests: scores are meaningless without converted weights).

    ``fast_softmax`` is the ``--bf16_softmax`` mode: attention probabilities in bf16
    (``ops/attention.py``). The pair path runs its whole graph in it, the VAE encode included;
    the triplet paths run only the tail after the encode, so that cached moments are the same in
    both modes, as in the JAX scorer.

    ``enable_ip_adapter`` (``metrics/scorer_base.IPAdapterMixin``) attaches an IP-Adapter
    (ip-adapter-plus_sd15 by default, with CLIP ViT-H/14); ``score_batch(ip_adapter=True)``
    attaches random weights if none are."""

    hbm_scale = 1.0  # per-triplet device memory against SD-1.5's (runtime/hbm_guard.py)
    moment_cache_mb: float | None = None  # None => $DIFFSIM_TPU_MOMENT_CACHE_MB or 512

    def __init__(
        self,
        params=None,
        *,
        unet_cfg: UNetConfig | None = None,
        vae_cfg: VAEConfig | None = None,
        text_cfg: CLIPTextConfig | None = None,
        img_size: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        tokenizer=None,
        cfg_parity: bool = True,
        guidance_scale: float = 7.5,
        vae_mode: bool = False,
        fast_softmax: bool = False,
        init_seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.unet_cfg = unet_cfg or UNetConfig.sd15()
        self.vae_cfg = vae_cfg or VAEConfig.sd()
        self.text_cfg = text_cfg or CLIPTextConfig.sd15()
        self.img_size = img_size
        self.dtype = dtype
        # CFG parity: guidance_scale > 1 puts [uncond, cond] halves in the tapped batch and
        # both enter the score; cfg_parity=False keeps only the cond half
        self.cfg_parity = cfg_parity and guidance_scale > 1.0
        self.vae_mode = vae_mode
        self.fast_softmax = fast_softmax
        self._moment_cache = None
        if tokenizer is None and params is not None:
            print("[tokenizer] weights were supplied but no CLIP tokenizer: falling back to "
                  "the HashTokenizer, so prompt embeddings are garbage and scores are "
                  "meaningless. Pass tokenizer=CLIPTokenizer.from_files(vocab.json, "
                  "merges.txt) for real scoring.")
        self.tokenizer = tokenizer or HashTokenizer(self.text_cfg.vocab_size)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(init_seed))
        kinds = ("unet", "vae", "text")
        if params is not None and sorted(params) != sorted(kinds):
            raise ValueError(f"params must hold exactly {kinds}, got {sorted(params)}")
        trees = params if params is not None else dict.fromkeys(kinds)
        self.unet = build_module(lambda: UNet(self.unet_cfg), trees["unet"], "unet",
                                 self.device, dtype, gen)
        self.vae = build_module(lambda: Encoder(self.vae_cfg), trees["vae"], "vae",
                                self.device, dtype, gen)
        self.text = build_module(lambda: CLIPText(self.text_cfg), trees["text"], "text",
                                 self.device, dtype, gen)
        self._prompt_cache: dict[str, torch.Tensor] = {}

    def _default_resampler_cfg(self) -> ResamplerConfig:
        return ResamplerConfig.sd15_plus()

    # ------------------------------------------------------------------
    # prompt encoding (cached per prompt string)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """(2, 77, hidden) [uncond(""), cond(prompt)] final-LN hidden states on the device."""
        if prompt not in self._prompt_cache:
            ids = torch.from_numpy(self.tokenizer(["", prompt]).astype(np.int64)).to(self.device)
            self._prompt_cache[prompt] = self.text(ids).to(self.dtype)
        return self._prompt_cache[prompt]

    def _embeds(self, prompts) -> torch.Tensor:
        """(P, 2, 77, hidden) per-item embeds, gathered from the unique-prompt table."""
        uniq, index, idx = [], {}, []
        for p in prompts:
            if p not in index:
                index[p] = len(uniq)
                uniq.append(self.encode_prompt(p))
            idx.append(index[p])
        return torch.stack(uniq)[torch.as_tensor(idx, device=self.device)]

    # ------------------------------------------------------------------
    # the scoring graph
    # ------------------------------------------------------------------

    def _encode(self, roles) -> torch.Tensor:
        """n NHWC role arrays of P images -> moments (P, n, 2C, h, w) pair-major, encoded in the
        VAE's slices."""
        return self._moments(to_device_pixels(roles, self.device, self.dtype), len(roles))

    def _moments(self, pix: torch.Tensor, n: int) -> torch.Tensor:
        """Role-major device pixels (n * P, 3, H, W) -> moments (P, n, 2C, h, w)."""
        moments = encode_chunked(self.vae, pix)
        return moments.reshape((n, pix.shape[0] // n) + moments.shape[1:]).transpose(0, 1)

    def _taps(self, moments, embeds, eps_vae, eps_noise, spec, tap: TapSpec, ip=None):
        """Moments (P, n, 2C, h, w) of n images per item, per-image noise (n, C, h, w) (eps_vae
        None => posterior mean) -> the tap's tensors, each (P, n * per_img, ...), and per_img.
        ``ip``: the UNet's IP-Adapter arguments (``IPAdapterMixin._ip_args``)."""
        P, n = moments.shape[:2]
        sf = self.vae_cfg.scaling_factor
        if eps_vae is None:
            z = sample_latents(moments, sf, mode=True)
        else:
            z = sample_latents(moments, sf, noise=eps_vae[None])
        x = (spec.a * z.float() + spec.b * eps_noise[None]).to(z.dtype)
        seq, hid = embeds.shape[-2:]
        if self.cfg_parity:
            # per-image CFG doubling: [uncond_a, cond_a, uncond_b, cond_b, ...]
            x_in = x.repeat_interleave(2, dim=1).reshape((P * n * 2,) + x.shape[2:])
            ctx = embeds.repeat(1, n, 1, 1).reshape(P * n * 2, seq, hid)
            per_img = 2
        else:
            x_in = x.reshape((P * n,) + x.shape[2:])
            ctx = embeds[:, 1:2].expand(P, n, seq, hid).reshape(P * n, seq, hid)
            per_img = 1
        model_t = torch.tensor(spec.model_t, dtype=torch.float32, device=self.device)
        _, taps = self.unet(x_in, model_t, ctx, tap=tap, **(ip or {}))
        return per_item(taps, P), per_img

    def _triplet_tail(self, moments, prompts, spec, tap: TapSpec, seed: int, similarity: str):
        """Moments (T, 3, 2C, h, w) of triplets [a, b, c] -> (s_ab, s_ac): everything after the
        VAE encode, shared by the pixel path and the cached path. A keeps its draws; B and C
        each play "image B". Runs in the fast mode when the scorer has it."""
        h, w = moments.shape[-2:]
        eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels, self.device)
        idx = torch.tensor([0, 1, 1], device=self.device)  # roles A, B, B
        with fast_softmax_mode(self.fast_softmax):
            taps, per_img = self._taps(moments, self._embeds(prompts),
                                       None if self.vae_mode else eps_vae[idx], eps_noise[idx],
                                       spec, tap)
            a, b, c = (slice(j * per_img, (j + 1) * per_img) for j in range(3))
            return pair_score(taps, a, b, similarity), pair_score(taps, a, c, similarity)

    def _score_pairs(self, pix_a, pix_b, prompt, tap: TapSpec, target_step: int, similarity: str,
                     seed: int, noise_override, masks=None) -> torch.Tensor:
        """(P,) scores of P pairs at ``tap``, by the readout of the tap's kind; the whole graph,
        VAE encode included, in the fast mode when the scorer has it. ``masks`` (P, 2, H, W)
        weight the queries of a QKV tap. A P whose estimate exceeds the device-memory budget
        raises ``HbmBudgetError`` before anything reaches the device
        (``runtime/hbm_guard.check_pairs``)."""
        P = pix_a.shape[0]
        hbm_guard.check_pairs(self, P)
        prompts = [prompt] * P if isinstance(prompt, str) else list(prompt)
        if len(prompts) != P:
            raise ValueError(f"{len(prompts)} prompts for {P} pairs")
        if tap.capture == IP_QKV:
            self._auto_enable_ip()  # its uncond tokens outside the fast mode, as in JAX
        with fast_softmax_mode(self.fast_softmax):
            pix = to_device_pixels([pix_a, pix_b], self.device, self.dtype)
            moments = self._moments(pix, 2)
            h, w = moments.shape[-2:]
            eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels,
                                            self.device, noise_override)
            if self.vae_mode and noise_override is None:
                eps_vae = None
            ip = self._ip_args(pix, P) if tap.capture == IP_QKV else None
            taps, per_img = self._taps(moments, self._embeds(prompts), eps_vae, eps_noise,
                                       schedulers.sd15_noise_spec(int(target_step)), tap, ip)
            weights = None
            if masks is not None and tap.capture == QKV:
                # a self-attention tap has one token per latent cell
                side = int(round(taps["q"].shape[-2] ** 0.5))
                weights = readout.mask_to_latent(
                    torch.as_tensor(np.asarray(masks, np.float32), device=self.device), side)
            return pair_score(taps, slice(0, per_img), slice(per_img, 2 * per_img), similarity,
                              weights)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def score_batch(
        self,
        pix_a: np.ndarray,
        pix_b: np.ndarray,
        *,
        prompt="",
        target_block: str = "up_blocks",
        target_layer=0,
        target_step: int = 600,
        similarity: str = "cosine",
        seed: int = 2333,
        ip_adapter: bool = False,
        fix_layer_collapse: bool = False,
        blocking: bool = True,
        mask_a: np.ndarray | None = None,
        mask_b: np.ndarray | None = None,
        noise_override: tuple | None = None,
        text_attn: bool = False,
    ):
        """Score P pairs; pix_a/pix_b (P, H, W, 3). ``prompt`` is one string or P strings.
        ``blocking=False`` returns a zero-arg callable that fetches the (P,) scores.
        ``noise_override``: (eps_vae, eps_noise), each (2, h, w, latent_c), replacing the
        seed-derived draws (the cross-framework parity mode). ``ip_adapter`` taps attn2's
        IP-Adapter keys and values (attaching random weights if no adapter is). ``mask_a`` /
        ``mask_b`` (P, H, W) foreground masks in [0, 1] weight the tapped queries of A and B per
        latent token (``readout.mask_to_latent``); IP taps ignore them, as in the JAX scorer."""
        tap = sd15_tap(target_block, target_layer, ip_adapter, fix_layer_collapse, text_attn)
        masks = None if mask_a is None else np.stack([mask_a, mask_b], axis=1)
        return fetchable(self._score_pairs(pix_a, pix_b, prompt, tap, target_step, similarity,
                                           seed, noise_override, masks), blocking)

    @torch.inference_mode()
    def score_triplet_batch(
        self,
        pix_a: np.ndarray,
        pix_b: np.ndarray,
        pix_c: np.ndarray,
        *,
        prompt="",
        target_block: str = "up_blocks",
        target_layer=0,
        target_step: int = 600,
        similarity: str = "cosine",
        seed: int = 2333,
        fix_layer_collapse: bool = False,
        blocking: bool = True,
        chunk: int | None = None,
        text_attn: bool = False,
    ):
        """(s_ab, s_ac) for T 2AFC triplets: equal to two score_batch calls, sharing A's VAE
        encode and UNet forwards (A keeps its draws; B and C each play "image B"). ``chunk``
        scores ``chunk`` triplets at a time, bounding peak activation memory; without it the
        device-memory guard picks the largest chunk that fits (``runtime/hbm_guard.py``)."""
        tap = sd15_tap(target_block, target_layer, False, fix_layer_collapse, text_attn)
        prompts = triplet_prompts(prompt, len(pix_a), len(pix_b), len(pix_c))
        return triplet_scores(self, lambda rows: self._encode([pix_a[rows], pix_b[rows],
                                                               pix_c[rows]]), prompts,
                              schedulers.sd15_noise_spec(int(target_step)), tap, seed,
                              similarity, chunk, blocking)

    def _ensure_moment_cache(self):
        return moment_cache(self, self.dtype)

    @torch.inference_mode()
    def score_triplet_paths(
        self,
        paths_a,
        paths_b,
        paths_c,
        pix_a: np.ndarray | None = None,
        pix_b: np.ndarray | None = None,
        pix_c: np.ndarray | None = None,
        *,
        loader=None,
        row_map: dict | None = None,
        prompt="",
        target_block: str = "up_blocks",
        target_layer=0,
        target_step: int = 600,
        similarity: str = "cosine",
        seed: int = 2333,
        fix_layer_collapse: bool = False,
        blocking: bool = True,
        chunk: int | None = None,
        text_attn: bool = False,
    ):
        """(s_ab, s_ac) for T triplets of image paths. Each unique image is decoded and
        VAE-encoded once into the device moment pool; the scores gather the pool's rows and run
        the tail of :meth:`score_triplet_batch`. ``pix_a/b/c``: the decoded (T, H, W, 3) uint8
        arrays where the caller has them; they feed cache misses. Otherwise misses are decoded
        by ``loader`` (an ``ImageLoader`` with the uint8 preprocess) or from disk."""
        tap = sd15_tap(target_block, target_layer, False, fix_layer_collapse, text_attn)
        prompts = triplet_prompts(prompt, len(paths_a), len(paths_b), len(paths_c))
        moments_of = pool_moments(self, (paths_a, paths_b, paths_c), (pix_a, pix_b, pix_c),
                                  loader, row_map)
        return triplet_scores(self, moments_of, prompts,
                              schedulers.sd15_noise_spec(int(target_step)), tap, seed,
                              similarity, chunk, blocking)

    def diffsim(self, image_a, image_b, img_size=None, prompt="", target_block="up_blocks",
                target_layer=(0,), target_step=600, ip_adapter=False, seed=2333,
                similarity="cosine", **_):
        """Reference-shaped single-pair entry point: paths or PIL images in, float out."""
        size = img_size or self.img_size
        pa = load_and_process(image_a, size)
        pb = load_and_process(image_b, size)
        return float(self.score_batch(
            pa, pb, prompt=prompt, target_block=target_block, target_layer=target_layer,
            target_step=target_step, similarity=similarity, seed=seed, ip_adapter=ip_adapter,
        )[0])

    @torch.inference_mode()
    def score_feats_batch(
        self,
        pix_a: np.ndarray,
        pix_b: np.ndarray,
        *,
        prompt="",
        target_block: str = "up_blocks",
        target_layer=0,
        target_step: int = 600,
        similarity: str = "cosine",
        seed: int = 2333,
        blocking: bool = True,
        noise_override: tuple | None = None,
    ):
        """The DiffFeats ablation (``--metric diffeats``): attn1's output features, min-max
        normalised, then cosine or MSE. Unlike the diffsim path, a length-1 ``target_layer``
        list unwraps to its layer. ``noise_override`` as in :meth:`score_batch`."""
        if isinstance(target_layer, (list, tuple)):
            target_layer = target_layer[0]
        base = sd15_tap(target_block, int(target_layer), fix_layer_collapse=True)
        tap = TapSpec(base.block, base.address, "attn1", OUTPUT)
        return fetchable(self._score_pairs(pix_a, pix_b, prompt, tap, target_step, similarity,
                                           seed, noise_override), blocking)

    @torch.inference_mode()
    def tap_values(self, image_a, *, prompt="", target_block="up_blocks", target_layer=(0,),
                   target_step=600, seed=2333):
        """Q, K, V of one image (paths or a PIL image), each (per_img, heads, S, D): the
        reference's ``diffsim_value`` retrieval helper with the standard block slicing. The
        image takes role A's draws from ``seed``; the batch is [uncond, cond] with CFG
        parity."""
        tap = sd15_tap(target_block, target_layer)
        moments = self._encode([load_and_process(image_a, self.img_size)])
        h, w = moments.shape[-2:]
        eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels, self.device)
        taps, _ = self._taps(moments, self.encode_prompt(prompt)[None], eps_vae[:1],
                             eps_noise[:1], schedulers.sd15_noise_spec(int(target_step)), tap)
        return tuple(taps[k][0] for k in ("q", "k", "v"))
