"""DiffSim scorer, SDXL backbone, on PyTorch and CUDA.

Counterpart of ``diffsim_tpu/metrics/diffsim_xl.py``, with the same public layouts as the SD-1.5
port (``metrics/diffsim_sd15.py``): pixels NHWC, ``noise_override`` = ``(eps_vae, eps_noise)``,
each (2, h, w, 4). What differs from SD-1.5, all kept from the JAX scorer:

* two text towers: the conditioning is the concatenation of both towers' PENULTIMATE hidden
  states (768 + 1280 = 2048 wide) plus tower 2's projected pooled embedding, and the empty
  negative prompt is all zeros (SDXL base's ``force_zeros_for_empty_prompt``);
* micro-conditioning ``time_ids`` from the UNet's default 1024 x 1024 canvas, whatever the image
  size (:meth:`DiffSimXL.default_time_ids`);
* Euler "leading" noising with the ``init_noise_sigma`` amplification
  (``core.schedulers.sdxl_noise_spec``, quirk Q6);
* the VAE encodes in float32 (``vae_fp32=True``) in slices of the JAX package's default chunk
  (2 images at 1024 px), then the latents are cast to the scoring dtype. The float32 encode
  keeps PyTorch's defaults, as the reference's own torch run had them: cuDNN convolutions in
  TF32 (``torch.backends.cudnn.allow_tf32``), matrix products in full float32. At 1024 px its
  mid attention runs K4 (``ops/kernels/attention_stream.py``);
* 3-index taps [block, attention, transformer] (:func:`sdxl_tap`); every SDXL tap has at least
  1024 tokens at head dim 64, so the readout runs K3 (``ops/kernels/readout.py``);
* ``score_batch(ip_adapter=True)`` taps attn2's IP-Adapter keys and values
  (ip-adapter-plus_sdxl_vit-h by default), the adapter tokens made from the scored images at
  the scoring resolution. Its 16 image keys are not square, so the readout takes the math path.

Scoring runs on ``cuda`` unless ``device`` is given; without a CUDA device and without a
``device`` the constructor raises. Default dtype bf16, as in the JAX scorer.
``score_triplet_paths`` scores through the device moment cache, as the SD-1.5 port does; its
pool holds the VAE's output dtype (float32 with ``vae_fp32``, 0.5 MB an image at 1024 px).
"""

from __future__ import annotations

import numpy as np
import torch

from diffsim_tpu_torch.core import schedulers
from diffsim_tpu_torch.core.image import load_and_process
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
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
from diffsim_tpu_torch.ops.taps import IP_QKV, QKV, TapSpec
from diffsim_tpu_torch.runtime import hbm_guard
from diffsim_tpu_torch.runtime.profiling import span, spanned

KINDS = ("unet", "vae", "text", "text2")


def sdxl_tap(target_block: str, target_layer, ip_adapter: bool = False) -> TapSpec:
    """[block, attention, transformer] -> an absolute TapSpec (``diffsim_tpu`` ``sdxl_tap``):
    down_blocks[1:][b] is absolute down block b + 1, up_blocks[:-1][b] absolute up block b, and
    mid takes [attention, transformer] only. ``ip_adapter`` taps attn2's IP-Adapter keys and
    values (IP_QKV)."""
    tl = list(target_layer) if isinstance(target_layer, (list, tuple)) else [target_layer]
    attn = "attn2" if ip_adapter else "attn1"
    capture = IP_QKV if ip_adapter else QKV
    if target_block == "mid_blocks":
        a, t = (tl + [0, 0])[:2]
        return TapSpec("mid", (0, int(a), int(t)), attn, capture)
    if len(tl) != 3:
        raise ValueError("SDXL down/up taps take 3 indices: block, attention, transformer")
    b, a, t = (int(x) for x in tl)
    if target_block == "down_blocks":
        return TapSpec("down", (b + 1, a, t), attn, capture)
    if target_block == "up_blocks":
        return TapSpec("up", (b, a, t), attn, capture)
    raise ValueError(f"unknown target_block: {target_block}")


class DiffSimXL(IPAdapterMixin):
    """Batched SDXL DiffSim. ``params`` is the JAX package's parameter tree
    {'unet', 'vae' (encoder), 'text', 'text2'} as numpy arrays, bridged strictly; if None, the
    weights are random, drawn on the device from ``torch.Generator`` seeded with ``init_seed``
    (throughput and tests: scores are meaningless without converted weights)."""

    # per-triplet device memory against SD-1.5's at one resolution (runtime/hbm_guard.py): the
    # scoring tail's slope between 2 and 4 SDXL triplets at 1024 px, 0.724 GB, over 4 x SD-1.5's
    # constant, 0.453, rounded up (chip_smoke.py, H100 80GB HBM3, 700 W)
    hbm_scale = 0.5
    moment_cache_mb: float | None = None  # None => $DIFFSIM_TPU_MOMENT_CACHE_MB or 512

    def __init__(
        self,
        params=None,
        *,
        unet_cfg: UNetConfig | None = None,
        vae_cfg: VAEConfig | None = None,
        text_cfg: CLIPTextConfig | None = None,
        text2_cfg: CLIPTextConfig | None = None,
        img_size: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        tokenizer=None,
        tokenizer2=None,
        cfg_parity: bool = True,
        vae_mode: bool = False,
        vae_fp32: bool = True,
        init_seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.unet_cfg = unet_cfg or UNetConfig.sdxl()
        self.vae_cfg = vae_cfg or VAEConfig.sdxl()
        self.text_cfg = text_cfg or CLIPTextConfig.sd15()
        self.text2_cfg = text2_cfg or CLIPTextConfig.sdxl_big_g()
        self.img_size = img_size
        self.dtype = dtype
        self.cfg_parity = cfg_parity
        self.vae_mode = vae_mode
        self.enc_dtype = torch.float32 if vae_fp32 else dtype
        self._moment_cache = None
        if tokenizer is None and params is not None:
            print("[tokenizer] weights were supplied but no CLIP tokenizer: falling back to "
                  "the HashTokenizer, so prompt embeddings are garbage and scores are "
                  "meaningless. Pass tokenizer= / tokenizer2= for real scoring.")
        self.tokenizer = tokenizer or HashTokenizer(self.text_cfg.vocab_size)
        # tokenizer 2 pads with "!" (token 0) instead of EOS: derive that view from a CLIP
        # tokenizer given without an explicit tokenizer2
        if tokenizer2 is None and hasattr(tokenizer, "with_pad_token"):
            tokenizer2 = tokenizer.with_pad_token("!")
        self.tokenizer2 = tokenizer2 or tokenizer or HashTokenizer(self.text2_cfg.vocab_size)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(init_seed))
        if params is not None and sorted(params) != sorted(KINDS):
            raise ValueError(f"params must hold exactly {KINDS}, got {sorted(params)}")
        trees = params if params is not None else dict.fromkeys(KINDS)
        self.unet = build_module(lambda: UNet(self.unet_cfg), trees["unet"], "unet",
                                 self.device, dtype, gen)
        self.vae = build_module(lambda: Encoder(self.vae_cfg), trees["vae"], "vae",
                                self.device, self.enc_dtype, gen)
        self.text = build_module(lambda: CLIPText(self.text_cfg), trees["text"], "text",
                                 self.device, dtype, gen)
        self.text2 = build_module(lambda: CLIPText(self.text2_cfg), trees["text2"], "text2",
                                  self.device, dtype, gen)
        self._prompt_cache: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def _default_resampler_cfg(self) -> ResamplerConfig:
        return ResamplerConfig.sdxl_plus()

    # ------------------------------------------------------------------
    # conditioning
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompt(self, prompt: str) -> tuple[torch.Tensor, torch.Tensor]:
        """((2, 77, 2048) embeds, (2, pooled_dim) pooled) for [uncond (zeros), cond], on the
        device in the scoring dtype."""
        if prompt not in self._prompt_cache:
            def ids(tok):
                ids = torch.from_numpy(tok([prompt]).astype(np.int64))
                with span("sync.prompt_ids"):
                    return ids.to(self.device)

            out1 = self.text.encode(ids(self.tokenizer), output_hidden_states=True)
            out2 = self.text2.encode(ids(self.tokenizer2), output_hidden_states=True)
            embeds = torch.cat([out1["hidden_states"][-2], out2["hidden_states"][-2]],
                               dim=-1).to(self.dtype)
            pooled = out2["text_embeds"].to(self.dtype)
            # force_zeros_for_empty_prompt: the uncond half is all zeros
            self._prompt_cache[prompt] = (torch.cat([torch.zeros_like(embeds), embeds]),
                                          torch.cat([torch.zeros_like(pooled), pooled]))
        return self._prompt_cache[prompt]

    def _embeds(self, prompts):
        """(P, 2, 77, hid) embeds and (P, 2, pooled_dim) pooled per item, gathered from the
        unique-prompt table."""
        with span("prompts"):
            uniq, index, idx = [], {}, []
            for p in prompts:
                if p not in index:
                    index[p] = len(uniq)
                    uniq.append(self.encode_prompt(p))
                idx.append(index[p])
            with span("sync.prompt_index"):
                sel = torch.as_tensor(idx, device=self.device)
            return (torch.stack([e for e, _ in uniq])[sel],
                    torch.stack([p for _, p in uniq])[sel])

    @staticmethod
    def default_time_ids() -> np.ndarray:
        """(1024, 1024, 0, 0, 1024, 1024): original size, crop, target size from the UNet's
        default canvas, independent of the image size (a quirk of the reference pipeline)."""
        return np.asarray([1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0], np.float32)

    # ------------------------------------------------------------------
    # the scoring graph
    # ------------------------------------------------------------------

    def _encode(self, roles) -> torch.Tensor:
        """n NHWC role arrays of P images -> moments (P, n, 2C, h, w) pair-major, encoded in
        the VAE's dtype in slices of the default chunk."""
        return self._moments(to_device_pixels(roles, self.device, self.enc_dtype), len(roles))

    def _moments(self, pix: torch.Tensor, n: int) -> torch.Tensor:
        """Role-major device pixels (n * P, 3, H, W) -> moments (P, n, 2C, h, w)."""
        moments = encode_chunked(self.vae, pix)
        return moments.reshape((n, pix.shape[0] // n) + moments.shape[1:]).transpose(0, 1)

    def _taps(self, moments, embeds, pooled, eps_vae, eps_noise, spec, tap: TapSpec, ip=None):
        """Moments (P, n, 2C, h, w), per-image noise (n, C, h, w) (eps_vae None => posterior
        mean) -> the tap's tensors, each (P, n * per_img, ...), and per_img. ``ip``: the UNet's
        IP-Adapter arguments (``IPAdapterMixin._ip_args``)."""
        P, n = moments.shape[:2]
        sf = self.vae_cfg.scaling_factor
        with span("noise"):
            if eps_vae is None:
                z = sample_latents(moments, sf, mode=True)
            else:
                z = sample_latents(moments, sf, noise=eps_vae[None])
            z = z.to(self.dtype)
            x = (spec.a * z.float() + spec.b * eps_noise[None]).to(self.dtype)
            seq, hid = embeds.shape[-2:]
            if self.cfg_parity:
                # per-image CFG doubling: [uncond_a, cond_a, uncond_b, cond_b, ...]
                x_in = x.repeat_interleave(2, dim=1).reshape((P * n * 2,) + x.shape[2:])
                ctx = embeds.repeat(1, n, 1, 1).reshape(P * n * 2, seq, hid)
                pool = pooled.repeat(1, n, 1).reshape(P * n * 2, -1)
                per_img = 2
            else:
                x_in = x.reshape((P * n,) + x.shape[2:])
                ctx = embeds[:, 1:2].expand(P, n, seq, hid).reshape(P * n, seq, hid)
                pool = pooled[:, 1:2].expand(P, n, pooled.shape[-1]).reshape(P * n, -1)
                per_img = 1
        with span("sync.time_ids"):
            time_ids = torch.as_tensor(self.default_time_ids(), device=self.device)
        added = {"text_embeds": pool.to(self.dtype),
                 "time_ids": time_ids[None].expand(x_in.shape[0], -1)}
        with span("sync.model_t"):
            model_t = torch.tensor(spec.model_t, dtype=torch.float32, device=self.device)
        with span("unet"):
            _, taps = self.unet(x_in, model_t, ctx, tap=tap, added_cond=added, **(ip or {}))
        return per_item(taps, P), per_img

    def _triplet_tail(self, moments, prompts, spec, tap: TapSpec, seed: int, similarity: str):
        """Moments (T, 3, 2C, h, w) of triplets [a, b, c] -> (s_ab, s_ac): everything after the
        VAE encode, shared by the pixel path and the cached path. A keeps its draws; B and C
        each play "image B"."""
        h, w = moments.shape[-2:]
        eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels, self.device)
        with span("sync.role_index"):
            idx = torch.tensor([0, 1, 1], device=self.device)  # roles A, B, B
        taps, per_img = self._taps(moments, *self._embeds(prompts),
                                   None if self.vae_mode else eps_vae[idx], eps_noise[idx],
                                   spec, tap)
        a, b, c = (slice(j * per_img, (j + 1) * per_img) for j in range(3))
        return pair_score(taps, a, b, similarity), pair_score(taps, a, c, similarity)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @spanned("score_batch")
    @torch.inference_mode()
    def score_batch(
        self,
        pix_a: np.ndarray,
        pix_b: np.ndarray,
        *,
        prompt="",
        target_block: str = "up_blocks",
        target_layer=(0, 0, 0),
        target_step: int = 900,
        similarity: str = "cosine",
        seed: int = 2333,
        ip_adapter: bool = False,
        blocking: bool = True,
        noise_override: tuple | None = None,
    ):
        """Score P pairs; pix_a/pix_b (P, H, W, 3). ``prompt`` is one string or P strings.
        ``blocking=False`` returns a zero-arg callable that fetches the (P,) scores.
        ``noise_override``: (eps_vae, eps_noise), each (2, h, w, latent_c), replacing the
        seed-derived draws (the cross-framework parity mode). ``ip_adapter`` taps attn2's
        IP-Adapter keys and values (attaching random weights if no adapter is). A P whose
        estimate exceeds the device-memory budget raises ``HbmBudgetError`` before anything
        reaches the device (``runtime/hbm_guard.check_pairs``)."""
        tap = sdxl_tap(target_block, target_layer, ip_adapter)
        P = pix_a.shape[0]
        hbm_guard.check_pairs(self, P)
        prompts = [prompt] * P if isinstance(prompt, str) else list(prompt)
        if len(prompts) != P:
            raise ValueError(f"{len(prompts)} prompts for {P} pairs")
        pix = to_device_pixels([pix_a, pix_b], self.device, self.enc_dtype)
        moments = self._moments(pix, 2)
        h, w = moments.shape[-2:]
        eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels, self.device,
                                        noise_override)
        if self.vae_mode and noise_override is None:
            eps_vae = None
        ip = None
        if ip_adapter:
            self._auto_enable_ip()
            ip = self._ip_args(pix, P)
        taps, per_img = self._taps(moments, *self._embeds(prompts), eps_vae, eps_noise,
                                   schedulers.sdxl_noise_spec(int(target_step)), tap, ip)
        scores = pair_score(taps, slice(0, per_img), slice(per_img, 2 * per_img), similarity)
        return fetchable(scores, blocking)

    @spanned("score_triplet_batch")
    @torch.inference_mode()
    def score_triplet_batch(
        self,
        pix_a: np.ndarray,
        pix_b: np.ndarray,
        pix_c: np.ndarray,
        *,
        prompt="",
        target_block: str = "up_blocks",
        target_layer=(0, 0, 0),
        target_step: int = 900,
        similarity: str = "cosine",
        seed: int = 2333,
        blocking: bool = True,
        chunk: int | None = None,
    ):
        """(s_ab, s_ac) for T 2AFC triplets: equal to two score_batch calls, sharing A's VAE
        encode and UNet forwards (A keeps its draws; B and C each play "image B"). ``chunk``
        scores ``chunk`` triplets at a time, bounding peak activation memory; without it the
        device-memory guard picks the largest chunk that fits (``runtime/hbm_guard.py``)."""
        tap = sdxl_tap(target_block, target_layer)
        prompts = triplet_prompts(prompt, len(pix_a), len(pix_b), len(pix_c))
        return triplet_scores(self, lambda rows: self._encode([pix_a[rows], pix_b[rows],
                                                               pix_c[rows]]), prompts,
                              schedulers.sdxl_noise_spec(int(target_step)), tap, seed,
                              similarity, chunk, blocking)

    def _ensure_moment_cache(self):
        return moment_cache(self, self.enc_dtype)

    @spanned("score_triplet_paths")
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
        target_layer=(0, 0, 0),
        target_step: int = 900,
        similarity: str = "cosine",
        seed: int = 2333,
        blocking: bool = True,
        chunk: int | None = None,
    ):
        """(s_ab, s_ac) for T triplets of image paths through the device moment cache: each
        unique image is decoded and VAE-encoded once (see ``DiffSimSD15.score_triplet_paths``;
        at 1024 px the float32 encode is most of a fresh call, which a hit skips)."""
        tap = sdxl_tap(target_block, target_layer)
        prompts = triplet_prompts(prompt, len(paths_a), len(paths_b), len(paths_c))
        moments_of = pool_moments(self, (paths_a, paths_b, paths_c), (pix_a, pix_b, pix_c),
                                  loader, row_map)
        return triplet_scores(self, moments_of, prompts,
                              schedulers.sdxl_noise_spec(int(target_step)), tap, seed,
                              similarity, chunk, blocking)

    def diffsim_score(self, image_a, image_b, img_size=None, prompt="",
                      target_block="up_blocks", target_layer=(0, 0, 0), target_step=900,
                      similarity="cosine", seed=2333, ip_adapter=False):
        """Reference-shaped single-pair entry point: paths or PIL images in, float out."""
        size = img_size or self.img_size
        pa = load_and_process(image_a, size)
        pb = load_and_process(image_b, size)
        return float(self.score_batch(
            pa, pb, prompt=prompt, target_block=target_block, target_layer=target_layer,
            target_step=target_step, similarity=similarity, seed=seed, ip_adapter=ip_adapter,
        )[0])
