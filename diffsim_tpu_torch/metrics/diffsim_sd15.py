"""DiffSim scorer, SD-1.5 backbone, on PyTorch and CUDA.

Counterpart of ``diffsim_tpu/metrics/diffsim_sd15.py``, with the same public layouts: pixels
are NHWC (P, H, W, 3) uint8 or float in [-1, 1], taps (B, heads, S, D), ``noise_override`` is
``(eps_vae, eps_noise)``, each (2, h, w, 4). The graph per call:

    pixels -> VAE encode -> posterior sample -> q_sample to t -> UNet over the CFG-doubled
    batch [uncond_a, cond_a, uncond_b, cond_b], stopping at the tap -> cross/self attention
    readout -> (P,) scores

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
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig, sample_latents
from diffsim_tpu_torch.ops.taps import QKV, TapSpec


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch scorer yet "
                               "(ROADMAP.md, Queue 1)")


def sd15_tap(target_block: str, target_layer, ip_adapter: bool = False,
             fix_layer_collapse: bool = False, text_attn: bool = False) -> TapSpec:
    """The reference CLI addressing -> an absolute TapSpec (``diffsim_tpu`` ``sd15_tap``).

    A length-1 ``target_layer`` list collapses to layer 0 (the reference's quirk, kept by
    default; ``fix_layer_collapse=True`` unwraps it). Down taps address absolute down block L,
    up taps absolute up block L + 1, always ``attentions[-1].transformer_blocks[-1]``;
    ``text_attn`` taps the text cross-attention (attn2) instead of attn1."""
    if isinstance(target_layer, (list, tuple)):
        if len(target_layer) == 1:
            target_layer = target_layer[0] if fix_layer_collapse else 0
        else:
            raise ValueError("SD-1.5 takes a single target_layer index")
    if ip_adapter:
        raise _not_ported("IP-Adapter")
    attn = "attn2" if text_attn else "attn1"
    if target_block == "down_blocks":
        return TapSpec("down", (int(target_layer), -1, -1), attn, QKV)
    if target_block == "mid_blocks":
        return TapSpec("mid", (0, -1, -1), attn, QKV)
    if target_block == "up_blocks":
        return TapSpec("up", (int(target_layer) + 1, -1, -1), attn, QKV)
    raise ValueError(f"unknown target_block: {target_block}")


class DiffSimSD15:
    """Batched SD-1.5 DiffSim. ``params`` is the JAX package's parameter tree
    {'unet', 'vae' (encoder), 'text'} as numpy arrays, bridged strictly; if None, the weights
    are random, drawn on the device from ``torch.Generator`` seeded with ``init_seed``
    (throughput and tests: scores are meaningless without converted weights)."""

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
        if fast_softmax:
            raise _not_ported("fast_softmax (the K1 bf16_probs mode)")
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
        """n NHWC role arrays of P images -> moments (P, n, 2C, h, w) pair-major."""
        pix = to_device_pixels(roles, self.device, self.dtype)
        moments = self.vae(pix)
        n, P = len(roles), roles[0].shape[0]
        return moments.reshape((n, P) + moments.shape[1:]).transpose(0, 1)

    def _taps(self, moments, embeds, eps_vae, eps_noise, spec, tap: TapSpec):
        """Moments (P, n, 2C, h, w) of n images per item, per-image noise (n, C, h, w) (eps_vae
        None => posterior mean) -> q, k, v each (P, n * per_img, heads, S, D), and per_img."""
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
        _, taps = self.unet(x_in, model_t, ctx, tap=tap)
        nb = n * per_img
        return [t.reshape((P, nb) + t.shape[1:]) for t in (taps["q"], taps["k"], taps["v"])], per_img

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
        seed-derived draws (the cross-framework parity mode)."""
        if mask_a is not None or mask_b is not None:
            raise _not_ported("mask-weighted queries")
        tap = sd15_tap(target_block, target_layer, ip_adapter, fix_layer_collapse, text_attn)
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
        qkv, per_img = self._taps(moments, self._embeds(prompts), eps_vae, eps_noise,
                                  schedulers.sd15_noise_spec(int(target_step)), tap)
        scores = pair_score(qkv, slice(0, per_img), slice(per_img, 2 * per_img),
                                  similarity)
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
        scores ``chunk`` triplets at a time, bounding peak activation memory."""
        tap = sd15_tap(target_block, target_layer, False, fix_layer_collapse, text_attn)
        T = pix_a.shape[0]
        prompts = [prompt] * T if isinstance(prompt, str) else list(prompt)
        if len(prompts) != T:
            raise ValueError(f"{len(prompts)} prompts for {T} triplets")
        spec = schedulers.sd15_noise_spec(int(target_step))
        step = chunk or T
        s_ab, s_ac = [], []
        for i in range(0, T, step):
            sl = slice(i, i + step)
            moments = self._encode([pix_a[sl], pix_b[sl], pix_c[sl]])
            h, w = moments.shape[-2:]
            eps_vae, eps_noise = role_noise(seed, h, w, self.vae_cfg.latent_channels,
                                            self.device)
            idx = torch.tensor([0, 1, 1], device=self.device)  # roles A, B, B
            qkv, per_img = self._taps(
                moments, self._embeds(prompts[sl]),
                None if self.vae_mode else eps_vae[idx], eps_noise[idx], spec, tap)
            a, b, c = (slice(j * per_img, (j + 1) * per_img) for j in range(3))
            s_ab.append(pair_score(qkv, a, b, similarity))
            s_ac.append(pair_score(qkv, a, c, similarity))
        return fetchable_pair(torch.cat(s_ab), torch.cat(s_ac), blocking)

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

    # ------------------------------------------------------------------
    # entry points of the JAX scorer that later slices port
    # ------------------------------------------------------------------

    def score_feats_batch(self, *args, **kwargs):
        raise _not_ported("score_feats_batch (DiffFeats OUTPUT taps)")

    def tap_values(self, *args, **kwargs):
        raise _not_ported("tap_values")

    def score_triplet_paths(self, *args, **kwargs):
        raise _not_ported("score_triplet_paths (the device moment cache)")

    def enable_ip_adapter(self, *args, **kwargs):
        raise _not_ported("IP-Adapter")
