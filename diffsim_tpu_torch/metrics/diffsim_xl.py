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
  1024 tokens at head dim 64, so the readout runs K3 (``ops/kernels/readout.py``).

Scoring runs on ``cuda`` unless ``device`` is given; without a CUDA device and without a
``device`` the constructor raises. Default dtype bf16, as in the JAX scorer.
"""

from __future__ import annotations

import numpy as np
import torch

from diffsim_tpu_torch.core import schedulers
from diffsim_tpu_torch.core.image import load_and_process
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
from diffsim_tpu_torch.metrics.scorer_base import (
    build_module,
    fetchable,
    fetchable_pair,
    pair_score,
    resolve_device,
    role_noise,
    to_device_pixels,
)
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig, encode_chunked, sample_latents
from diffsim_tpu_torch.ops.taps import QKV, TapSpec

KINDS = ("unet", "vae", "text", "text2")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch scorer yet "
                               "(ROADMAP.md, Queue 1)")


def sdxl_tap(target_block: str, target_layer, ip_adapter: bool = False) -> TapSpec:
    """[block, attention, transformer] -> an absolute TapSpec (``diffsim_tpu`` ``sdxl_tap``):
    down_blocks[1:][b] is absolute down block b + 1, up_blocks[:-1][b] absolute up block b, and
    mid takes [attention, transformer] only."""
    if ip_adapter:
        raise _not_ported("IP-Adapter")
    tl = list(target_layer) if isinstance(target_layer, (list, tuple)) else [target_layer]
    if target_block == "mid_blocks":
        a, t = (tl + [0, 0])[:2]
        return TapSpec("mid", (0, int(a), int(t)), "attn1", QKV)
    if len(tl) != 3:
        raise ValueError("SDXL down/up taps take 3 indices: block, attention, transformer")
    b, a, t = (int(x) for x in tl)
    if target_block == "down_blocks":
        return TapSpec("down", (b + 1, a, t), "attn1", QKV)
    if target_block == "up_blocks":
        return TapSpec("up", (b, a, t), "attn1", QKV)
    raise ValueError(f"unknown target_block: {target_block}")


class DiffSimXL:
    """Batched SDXL DiffSim. ``params`` is the JAX package's parameter tree
    {'unet', 'vae' (encoder), 'text', 'text2'} as numpy arrays, bridged strictly; if None, the
    weights are random, drawn on the device from ``torch.Generator`` seeded with ``init_seed``
    (throughput and tests: scores are meaningless without converted weights)."""

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

    # ------------------------------------------------------------------
    # conditioning
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompt(self, prompt: str) -> tuple[torch.Tensor, torch.Tensor]:
        """((2, 77, 2048) embeds, (2, pooled_dim) pooled) for [uncond (zeros), cond], on the
        device in the scoring dtype."""
        if prompt not in self._prompt_cache:
            def ids(tok):
                return torch.from_numpy(tok([prompt]).astype(np.int64)).to(self.device)

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
        uniq, index, idx = [], {}, []
        for p in prompts:
            if p not in index:
                index[p] = len(uniq)
                uniq.append(self.encode_prompt(p))
            idx.append(index[p])
        sel = torch.as_tensor(idx, device=self.device)
        return (torch.stack([e for e, _ in uniq])[sel], torch.stack([p for _, p in uniq])[sel])

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
        moments = encode_chunked(self.vae, to_device_pixels(roles, self.device, self.enc_dtype))
        n, P = len(roles), roles[0].shape[0]
        return moments.reshape((n, P) + moments.shape[1:]).transpose(0, 1)

    def _taps(self, moments, embeds, pooled, eps_vae, eps_noise, spec, tap: TapSpec):
        """Moments (P, n, 2C, h, w), per-image noise (n, C, h, w) (eps_vae None => posterior
        mean) -> q, k, v each (P, n * per_img, heads, S, D), and per_img."""
        P, n = moments.shape[:2]
        sf = self.vae_cfg.scaling_factor
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
        time_ids = torch.as_tensor(self.default_time_ids(), device=self.device)
        added = {"text_embeds": pool.to(self.dtype),
                 "time_ids": time_ids[None].expand(x_in.shape[0], -1)}
        model_t = torch.tensor(spec.model_t, dtype=torch.float32, device=self.device)
        _, taps = self.unet(x_in, model_t, ctx, tap=tap, added_cond=added)
        nb = n * per_img
        qkv = [t.reshape((P, nb) + t.shape[1:]) for t in (taps["q"], taps["k"], taps["v"])]
        return qkv, per_img

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
        seed-derived draws (the cross-framework parity mode)."""
        tap = sdxl_tap(target_block, target_layer, ip_adapter)
        P = pix_a.shape[0]
        prompts = [prompt] * P if isinstance(prompt, str) else list(prompt)
        if len(prompts) != P:
            raise ValueError(f"{len(prompts)} prompts for {P} pairs")
        moments = self._encode([pix_a, pix_b])
        h, w = moments.shape[-2:]
        eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels, self.device,
                                        noise_override)
        if self.vae_mode and noise_override is None:
            eps_vae = None
        qkv, per_img = self._taps(moments, *self._embeds(prompts), eps_vae, eps_noise,
                                  schedulers.sdxl_noise_spec(int(target_step)), tap)
        scores = pair_score(qkv, slice(0, per_img), slice(per_img, 2 * per_img), similarity)
        return fetchable(scores, blocking)

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
        scores ``chunk`` triplets at a time, bounding peak activation memory."""
        tap = sdxl_tap(target_block, target_layer)
        T = pix_a.shape[0]
        prompts = [prompt] * T if isinstance(prompt, str) else list(prompt)
        if len(prompts) != T:
            raise ValueError(f"{len(prompts)} prompts for {T} triplets")
        spec = schedulers.sdxl_noise_spec(int(target_step))
        step = chunk or T
        s_ab, s_ac = [], []
        for i in range(0, T, step):
            sl = slice(i, i + step)
            moments = self._encode([pix_a[sl], pix_b[sl], pix_c[sl]])
            h, w = moments.shape[-2:]
            eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels,
                                            self.device)
            idx = torch.tensor([0, 1, 1], device=self.device)  # roles A, B, B
            qkv, per_img = self._taps(moments, *self._embeds(prompts[sl]),
                                      None if self.vae_mode else eps_vae[idx], eps_noise[idx],
                                      spec, tap)
            a, b, c = (slice(j * per_img, (j + 1) * per_img) for j in range(3))
            s_ab.append(pair_score(qkv, a, b, similarity))
            s_ac.append(pair_score(qkv, a, c, similarity))
        return fetchable_pair(torch.cat(s_ab), torch.cat(s_ac), blocking)

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

    # ------------------------------------------------------------------
    # entry points of the JAX scorer that later slices port
    # ------------------------------------------------------------------

    def score_triplet_paths(self, *args, **kwargs):
        raise _not_ported("score_triplet_paths (the device moment cache)")

    def enable_ip_adapter(self, *args, **kwargs):
        raise _not_ported("IP-Adapter")
