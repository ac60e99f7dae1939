"""DiffSim scorer, DiT-XL/2 backbone, on PyTorch and CUDA.

Counterpart of ``diffsim_tpu/metrics/diffsim_dit.py``, with the public layouts of the SD-1.5
port (``metrics/diffsim_sd15.py``): pixels NHWC, ``noise_override`` = ``(eps_vae, eps_noise)``,
each (2, h, w, 4). The graph per call, as in the JAX scorer:

    pixels -> SD VAE encode -> posterior sample (the SD VAE's scaling factor) -> DDIM noising at
    raw t = target_step -> each image duplicated to batch 2 with y = [1, num_classes] (the null
    class is the last row of ``y_embedder``) -> DiT at the respaced model timestep
    (``core.schedulers.dit_noise_spec``), stopping at block ``target_layer``'s qkv -> the
    cross-image attention readout -> scores

Triplet rows go through the DiT as [a, a, b, b, c, c]. At 512 px the DiT has 1024 tokens at head
dim 72: its attention runs K1 (``ops/kernels/attention.py``) in every block before the tap, and
the readout runs K3 (``ops/kernels/readout.py``). The MLP is GELU-tanh, so K2 is not used; the
VAE's 4096-token mid attention takes the math path.

Scoring runs on ``cuda`` unless ``device`` is given; without a CUDA device and without a
``device`` the constructor raises. Default dtype bf16, as in the JAX scorer. The pixel path and
the path through the device moment cache share one tail (moments -> scores), so an all-hit
rescore repeats its scores bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from diffsim_tpu_torch.core import schedulers
from diffsim_tpu_torch.core.image import load_and_process
from diffsim_tpu_torch.metrics.scorer_base import (
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
from diffsim_tpu_torch.models.dit import DiT, DiTConfig, pos_embed_2d
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig, encode_chunked, sample_latents
from diffsim_tpu_torch.ops.taps import QKV, TapSpec
from diffsim_tpu_torch.runtime import hbm_guard

KINDS = ("dit", "vae")


class DiffSimDiT:
    """Batched DiT DiffSim. ``params`` is the JAX package's parameter tree {'dit', 'vae'
    (encoder)} as numpy arrays, bridged strictly; if None, the weights are random, drawn on the
    device from ``torch.Generator`` seeded with ``init_seed`` (throughput and tests: scores are
    meaningless without converted weights).

    The SD scorers' ``prompt`` and ``target_block`` arguments are accepted and ignored, as the
    JAX scorer does: DiT is class-conditioned, and its taps address ``blocks`` only."""

    # per-triplet device memory against SD-1.5's at one resolution (runtime/hbm_guard.py): the
    # scoring tail's slope between 8 and 16 DiT-XL/2 triplets at 512 px, 0.1706 GB, over SD-1.5's
    # constant, 0.4, rounded up (chip_smoke.py, H100 80GB HBM3, 700 W). The JAX scorer's 1.15 is
    # a TPU figure and is not kept.
    hbm_scale = 0.5
    moment_cache_mb: float | None = None  # None => $DIFFSIM_TPU_MOMENT_CACHE_MB or 512

    def __init__(
        self,
        params=None,
        *,
        dit_cfg: DiTConfig | None = None,
        vae_cfg: VAEConfig | None = None,
        img_size: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        vae_mode: bool = False,
        init_seed: int = 0,
    ):
        self.device = resolve_device(device)
        # DiT-XL/2 at the latent size, 1000 classes; the VAE is sd-vae-ft-mse (SD-1.5's)
        self.dit_cfg = dit_cfg or DiTConfig.xl2(input_size=img_size // 8)
        self.vae_cfg = vae_cfg or VAEConfig.sd()
        self.img_size = img_size
        self.dtype = dtype
        self.vae_mode = vae_mode
        self._moment_cache = None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(init_seed))
        if params is not None and sorted(params) != sorted(KINDS):
            raise ValueError(f"params must hold exactly {KINDS}, got {sorted(params)}")
        trees = params if params is not None else dict.fromkeys(KINDS)
        self.dit = build_module(lambda: DiT(self.dit_cfg), trees["dit"], "dit", self.device,
                                dtype, gen)
        if trees["dit"] is None:  # the fixed sin-cos table, as the JAX init builds it
            table = pos_embed_2d(self.dit_cfg.hidden, self.dit_cfg.tokens_per_side)
            self.dit.pos_embed.data.copy_(torch.from_numpy(table))
        self.vae = build_module(lambda: Encoder(self.vae_cfg), trees["vae"], "vae",
                                self.device, dtype, gen)

    @staticmethod
    def _resolve_layer(target_layer) -> int:
        """``target_layer`` as a block index: a list or tuple gives its first entry (the
        reference unwraps it correctly, unlike SD-1.5's collapse)."""
        if isinstance(target_layer, (list, tuple)):
            return int(target_layer[0])
        return int(target_layer)

    def _tap(self, target_layer) -> TapSpec:
        return TapSpec("blocks", (self._resolve_layer(target_layer),), "attn1", QKV)

    # ------------------------------------------------------------------
    # the scoring graph
    # ------------------------------------------------------------------

    def _encode(self, roles) -> torch.Tensor:
        """n NHWC role arrays of P images -> moments (P, n, 2C, h, w) pair-major, encoded in the
        VAE's slices."""
        moments = encode_chunked(self.vae, to_device_pixels(roles, self.device, self.dtype))
        n, P = len(roles), roles[0].shape[0]
        return moments.reshape((n, P) + moments.shape[1:]).transpose(0, 1)

    def _taps(self, moments, eps_vae, eps_noise, spec, tap: TapSpec):
        """Moments (P, n, 2C, h, w), per-image noise (n, C, h, w) (eps_vae None => posterior
        mean) -> the taps {q, k, v}, each (P, 2n, heads, S, D): every image twice, [cond, null
        class]."""
        P, n = moments.shape[:2]
        sf = self.vae_cfg.scaling_factor
        if eps_vae is None:
            z = sample_latents(moments, sf, mode=True)
        else:
            z = sample_latents(moments, sf, noise=eps_vae[None])
        x = (spec.a * z.float() + spec.b * eps_noise[None]).to(z.dtype)
        x_in = x.repeat_interleave(2, dim=1).reshape((P * n * 2,) + x.shape[2:])
        y = torch.tensor([1, self.dit_cfg.num_classes], device=self.device).repeat(P * n)
        model_t = torch.tensor(spec.model_t, dtype=torch.float32, device=self.device)
        _, taps = self.dit(x_in, model_t, y, tap=tap)
        return per_item(taps, P)

    def _triplet_tail(self, moments, prompts, spec, tap: TapSpec, seed: int, similarity: str):
        """Moments (T, 3, 2C, h, w) of triplets [a, b, c] -> (s_ab, s_ac): everything after the
        VAE encode, shared by the pixel path and the cached path. A keeps its draws; B and C
        each play "image B". ``prompts`` is unused (the chunk loop passes it to every tail)."""
        h, w = moments.shape[-2:]
        eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels, self.device)
        idx = torch.tensor([0, 1, 1], device=self.device)  # roles A, B, B
        taps = self._taps(moments, None if self.vae_mode else eps_vae[idx], eps_noise[idx],
                          spec, tap)
        a, b, c = slice(0, 2), slice(2, 4), slice(4, 6)
        return pair_score(taps, a, b, similarity), pair_score(taps, a, c, similarity)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def score_batch(
        self,
        pix_a: np.ndarray,
        pix_b: np.ndarray,
        *,
        target_layer=0,
        target_step: int = 600,
        similarity: str = "cosine",
        seed: int = 2333,
        blocking: bool = True,
        noise_override: tuple | None = None,
        **_,
    ):
        """Score P pairs; pix_a/pix_b (P, H, W, 3). ``blocking=False`` returns a zero-arg
        callable that fetches the (P,) scores. ``noise_override``: (eps_vae, eps_noise), each
        (2, h, w, latent_c), replacing the seed-derived draws (the cross-framework parity
        mode). A P whose estimate exceeds the device-memory budget raises ``HbmBudgetError``
        before anything reaches the device (``runtime/hbm_guard.check_pairs``)."""
        hbm_guard.check_pairs(self, pix_a.shape[0])
        tap = self._tap(target_layer)
        spec = schedulers.dit_noise_spec(int(target_step))
        moments = self._encode([pix_a, pix_b])
        h, w = moments.shape[-2:]
        eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels, self.device,
                                        noise_override)
        if self.vae_mode and noise_override is None:
            eps_vae = None
        taps = self._taps(moments, eps_vae, eps_noise, spec, tap)
        return fetchable(pair_score(taps, slice(0, 2), slice(2, 4), similarity), blocking)

    @torch.inference_mode()
    def score_triplet_batch(
        self,
        pix_a: np.ndarray,
        pix_b: np.ndarray,
        pix_c: np.ndarray,
        *,
        target_layer=0,
        target_step: int = 600,
        similarity: str = "cosine",
        seed: int = 2333,
        blocking: bool = True,
        chunk: int | None = None,
        **_,
    ):
        """(s_ab, s_ac) for T 2AFC triplets: equal to two score_batch calls, sharing A's VAE
        encode and DiT forwards (A keeps its draws; B and C each play "image B"). ``chunk``
        scores ``chunk`` triplets at a time, bounding peak activation memory; without it the
        device-memory guard picks the largest chunk that fits (``runtime/hbm_guard.py``)."""
        prompts = triplet_prompts("", len(pix_a), len(pix_b), len(pix_c))
        return triplet_scores(self, lambda rows: self._encode([pix_a[rows], pix_b[rows],
                                                               pix_c[rows]]), prompts,
                              schedulers.dit_noise_spec(int(target_step)),
                              self._tap(target_layer), seed, similarity, chunk, blocking)

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
        target_layer=13,
        target_step: int = 600,
        similarity: str = "cosine",
        seed: int = 2333,
        blocking: bool = True,
        chunk: int | None = None,
        **_,
    ):
        """(s_ab, s_ac) for T triplets of image paths through the device moment cache: each
        unique image is decoded and VAE-encoded once (see ``DiffSimSD15.score_triplet_paths``).
        The default tap is block 13, as in the JAX scorer."""
        prompts = triplet_prompts("", len(paths_a), len(paths_b), len(paths_c))
        moments_of = pool_moments(self, (paths_a, paths_b, paths_c), (pix_a, pix_b, pix_c),
                                  loader, row_map)
        return triplet_scores(self, moments_of, prompts,
                              schedulers.dit_noise_spec(int(target_step)),
                              self._tap(target_layer), seed, similarity, chunk, blocking)

    def diffsim_score(self, image_a, image_b, img_size=None, prompt="", target_block=None,
                      target_layer=(0,), target_step=600, similarity="cosine", seed=2333):
        """Reference-shaped single-pair entry point: paths or PIL images in, float out."""
        size = img_size or self.img_size
        pa = load_and_process(image_a, size)
        pb = load_and_process(image_b, size)
        return float(self.score_batch(pa, pb, target_layer=target_layer,
                                      target_step=target_step, similarity=similarity,
                                      seed=seed)[0])
