"""Shared machinery of the port's scorers: device choice, parameter placement and random
init, the asynchronous fetch contract of ``diffsim_tpu/metrics/scorer_base.py``, the readout of
each tap kind, and the IP-Adapter attachment of the SD-1.5 and SDXL scorers
(:class:`IPAdapterMixin`)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
from torch import nn

from diffsim_tpu_torch.convert import bridge
from diffsim_tpu_torch.core import prng
from diffsim_tpu_torch.core.image import CLIP_MEAN, CLIP_STD, load_and_process_u8
from diffsim_tpu_torch.metrics import readout
from diffsim_tpu_torch.models.clip_vision import CLIPVision, CLIPVisionConfig
from diffsim_tpu_torch.models.ip_adapter import (
    ImageProjection,
    Resampler,
    ResamplerConfig,
    attn2_modules,
    insert_ip_into_unet,
)
from diffsim_tpu_torch.ops.blocks import IPProjection
from diffsim_tpu_torch.parallel import mesh
from diffsim_tpu_torch.runtime.device_cache import (
    ensure_image_slots,
    make_moment_cache,
    resolve_cached_chunk,
)


def resolve_device(device) -> torch.device:
    """The scoring device: this rank's card, ``cuda:LOCAL_RANK`` (``cuda:0`` outside torchrun),
    unless the caller names one. Without a CUDA device and without an explicit ``device``,
    raise: the port never quietly scores on the CPU."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to score on the CPU")
    return mesh.local_device(device)


def fetchable(scores: torch.Tensor, blocking: bool):
    """``blocking=True`` returns the (N,) float32 scores now; ``blocking=False`` returns a
    zero-arg callable that fetches them, so the caller's host work overlaps the device's."""

    def fetch():
        return scores.float().cpu().numpy()

    return fetch() if blocking else fetch


def fetchable_pair(s_ab: torch.Tensor, s_ac: torch.Tensor, blocking: bool):
    """Triplet-path variant of :func:`fetchable`: one fetch for both (T,) score arrays."""

    def fetch():
        both = torch.stack([s_ab.float(), s_ac.float()]).cpu().numpy()
        return both[0], both[1]

    return fetch() if blocking else fetch


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill a materialised module in place from ``generator`` on the module's device, as the
    JAX ``*_init`` functions do: matrices and embedding tables N(0, 0.02), norm scales one,
    biases zero. One kernel per tensor on the card, so SD-1.5 at full width takes seconds."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.data.zero_()
        elif p.dim() == 1:
            p.data.fill_(1.0)
        else:
            p.data.normal_(0.0, 0.02, generator=generator)
    return module


def build_module(factory: Callable[[], nn.Module], tree, kind: str, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator) -> nn.Module:
    """Build ``factory()`` on the meta device, then fill it on ``device`` in ``dtype`` from the
    JAX tree ``tree`` through the strict bridge, or randomly from ``generator`` when ``tree``
    is None. Returned in eval mode with gradients off."""
    with torch.device("meta"):
        module = factory()
    if tree is None:
        module = init_random_(module.to_empty(device=device).to(dtype), generator)
    else:
        module = bridge.load(module, tree, kind, device, dtype)
    return module.eval().requires_grad_(False)


def to_device_pixels(roles, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """NHWC role arrays (uint8, or float in [-1, 1]; the first role's dtype decides, as in the
    JAX scorer) -> one NCHW batch on ``device``. uint8 maps to [-1, 1] on the device
    (``u8 / 127.5 - 1`` in f32, then cast)."""
    if np.asarray(roles[0]).dtype == np.uint8:
        pix = torch.from_numpy(np.concatenate([np.asarray(r, np.uint8) for r in roles]))
        pix = pix.to(device)
        pix = (pix.float() / 127.5 - 1.0).to(dtype)
    else:
        pix = torch.from_numpy(np.concatenate([np.asarray(r, np.float32) for r in roles]))
        pix = pix.to(device=device, dtype=dtype)
    return pix.permute(0, 3, 1, 2).contiguous()


def to_device_normalized(pixels, mean, std, device: torch.device) -> torch.Tensor:
    """NHWC pixels -> one float32 NCHW batch on ``device``, as the baseline scorers'
    ``_normalize``: uint8 becomes (u8 / 255 - mean) / std on the device; float pixels are taken
    as already normalised."""
    pixels = np.asarray(pixels)
    x = torch.from_numpy(np.ascontiguousarray(pixels)).to(device)
    if pixels.dtype == np.uint8:
        mean = torch.as_tensor(mean, device=device)
        std = torch.as_tensor(std, device=device)
        x = (x.float() / 255.0 - mean) / std
    return x.float().permute(0, 3, 1, 2).contiguous()


def unit_cosine_100(emb: torch.Tensor) -> torch.Tensor:
    """(2P, E) embeddings, A rows then B rows -> (P,) 100 x the cosine of each pair, the
    embeddings normalised in float32 as the JAX baselines do."""
    emb = emb.float()
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    n = emb.shape[0] // 2
    return 100.0 * (emb[:n] * emb[n:]).sum(dim=-1)


def host_cosine(fa: np.ndarray, fb: np.ndarray) -> np.ndarray:
    """Row cosines of two (N, E) arrays on the host, norms clamped at 1e-8 (the JAX
    baselines' fetch)."""
    fa, fb = np.asarray(fa, np.float32), np.asarray(fb, np.float32)
    dot = np.sum(fa * fb, axis=-1)
    na = np.maximum(np.linalg.norm(fa, axis=-1), 1e-8)
    nb = np.maximum(np.linalg.norm(fb, axis=-1), 1e-8)
    return dot / (na * nb)


def role_noise(seed: int, h: int, w: int, channels: int, device: torch.device,
               noise_override=None):
    """(eps_vae, eps_noise), each (2, C, h, w) f32 on ``device``: roles [A, B]. The draws come
    from ``seed`` (``core/prng.py``) unless ``noise_override`` gives them as two NHWC arrays
    (2, h, w, C), the cross-framework parity mode."""
    if noise_override is not None:
        return tuple(torch.as_tensor(np.asarray(e, np.float32), device=device)
                     .permute(0, 3, 1, 2) for e in noise_override)
    vae_a, vae_b, noise_a, noise_b = prng.role_noise(seed, (h, w, channels), device)
    return (torch.stack([vae_a, vae_b]).permute(0, 3, 1, 2),
            torch.stack([noise_a, noise_b]).permute(0, 3, 1, 2))


def per_item(taps: dict, P: int) -> dict:
    """The UNet's taps (rows, ...) as (P, rows / P, ...); list-valued taps (the IP-Adapter's
    per-adapter K/V) element by element."""
    def split(t):
        return t.reshape((P, t.shape[0] // P) + t.shape[1:])

    return {k: [split(t) for t in v] if isinstance(v, list) else split(v)
            for k, v in taps.items()}


def pair_score(taps: dict, sl_a: slice, sl_b: slice, similarity: str,
               mask_weights: torch.Tensor | None = None) -> torch.Tensor:
    """(P,) scores between the images at rows ``sl_a`` and ``sl_b`` of taps (P, rows, ...), by
    the readout of the tap's kind: the IP-Adapter readout of IP_QKV taps, the ``diffeats``
    readout (min-max normalised) of OUTPUT taps, the cross-image attention readout of QKV taps.
    ``mask_weights`` (P, 2, S) weights the QKV taps' queries of A and B per token."""
    if "ip_k" in taps:
        q, ks, vs = taps["q"], taps["ip_k"], taps["ip_v"]
        return readout.cross_attention_score_ip(
            q[:, sl_a], [k[:, sl_a] for k in ks], [v[:, sl_a] for v in vs],
            q[:, sl_b], [k[:, sl_b] for k in ks], [v[:, sl_b] for v in vs], similarity)
    if "out" in taps:
        out = taps["out"]
        return readout.feature_score(out[:, sl_a], out[:, sl_b], similarity,
                                     minmax_normalize=True)
    q, k, v = taps["q"], taps["k"], taps["v"]
    qa, qb = q[:, sl_a], q[:, sl_b]
    if mask_weights is not None:
        qa = qa * mask_weights[:, 0, None, None, :, None].to(qa.dtype)
        qb = qb * mask_weights[:, 1, None, None, :, None].to(qb.dtype)
    return readout.cross_attention_score(qa, k[:, sl_a], v[:, sl_a], qb, k[:, sl_b],
                                         v[:, sl_b], similarity)


def triplet_scores(scorer, moments_of: Callable, prompts, spec, tap, seed: int, similarity: str,
                   chunk, blocking: bool):
    """The chunk loop of both triplet paths of a scorer: ``moments_of(rows)`` gives the moments
    (t, 3, 2C, h, w) of the triplets at slice ``rows`` (encoded fresh, or gathered from the
    moment pool) and ``scorer._triplet_tail`` scores them. The chunk is ``chunk`` or the
    device-memory guard's (``runtime/hbm_guard.py``)."""
    T = len(prompts)
    step = resolve_cached_chunk(T, chunk, scorer)
    s_ab, s_ac = [], []
    for i in range(0, T, step):
        rows = slice(i, i + step)
        ab, ac = scorer._triplet_tail(moments_of(rows), prompts[rows], spec, tap, seed,
                                      similarity)
        s_ab.append(ab)
        s_ac.append(ac)
    return fetchable_pair(torch.cat(s_ab), torch.cat(s_ac), blocking)


def moment_cache(scorer, enc_dtype: torch.dtype):
    """The scorer's path-keyed VAE-moment pool (``runtime/device_cache.py``), built at first
    use in the encoder's dtype."""
    if scorer._moment_cache is None:
        scorer._moment_cache = make_moment_cache(scorer, enc_dtype)
    return scorer._moment_cache


def pool_moments(scorer, paths_roles, pix_roles, loader, row_map) -> Callable:
    """The host half of ``score_triplet_paths``: the three role path lists -> their slots in the
    scorer's moment pool, the misses decoded and encoded first; returns ``moments_of(rows)`` for
    :func:`triplet_scores`."""
    cache = scorer._ensure_moment_cache()
    idx3 = ensure_image_slots(cache, paths_roles, pix_roles, loader,
                              lambda k: load_and_process_u8(k, scorer.img_size), row_map=row_map)
    slots = torch.from_numpy(idx3).long().to(scorer.device)
    return lambda rows: cache.pool[slots[rows]]


def triplet_prompts(prompt, n: int, *lengths) -> list:
    """``prompt`` (one string or n strings) as a list of n, after checking that every role has
    n entries."""
    prompts = [prompt] * n if isinstance(prompt, str) else list(prompt)
    if len(prompts) != n or any(m != n for m in lengths):
        raise ValueError(f"{n} triplets with {len(prompts)} prompts and role lengths {lengths}")
    return prompts


class IPAdapterMixin:
    """The IP-Adapter attachment of the SD-1.5 and SDXL scorers (``diffsim_tpu``
    ``ScorerBase.enable_ip_adapter`` and its helpers). The scorer provides ``device``,
    ``dtype``, ``unet``, ``unet_cfg`` and ``_default_resampler_cfg()``. The image encoder and
    the projection head become the scorer's ``ip_encoder`` and ``ip_proj`` modules, on its
    device in its dtype, so the device-memory guard counts them."""

    _ip = None  # set by enable_ip_adapter
    ip_encoder: nn.Module | None = None
    ip_proj: nn.Module | None = None

    def _default_resampler_cfg(self) -> ResamplerConfig:
        raise NotImplementedError  # per backbone: sd15_plus / sdxl_plus

    @torch.no_grad()
    def enable_ip_adapter(self, converted=None, *, scale: float = 0.5, encoder_params=None,
                          encoder_cfg: CLIPVisionConfig | None = None,
                          resampler_cfg: ResamplerConfig | None = None, plus: bool = True,
                          init_seed: int = 1):
        """Attach IP-Adapter projections to every attn2 (the reference's load_ip_adapter and
        set_ip_adapter_scale(0.5)). ``converted`` is ``convert_ip_adapter``'s tree (numpy),
        ``encoder_params`` a ``convert_clip_vision`` tree of ``encoder_cfg`` (CLIP ViT-H/14 by
        default); each one None draws random weights on the device from ``init_seed``."""
        encoder_cfg = encoder_cfg or CLIPVisionConfig.h14()
        cross_dim = self.unet_cfg.cross_attention_dim
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(init_seed))
        proj = None
        ip_weights = [[None]] * len(attn2_modules(self.unet))
        if converted is not None:
            plus = bool(converted["plus"])
            ip_weights, proj = converted["ip_weights"], converted["image_proj"]
            if plus and resampler_cfg is None:
                lat = np.shape(proj["latents"])
                heads = np.shape(proj["layers"][0]["to_q"]["w"])[1] // 64
                resampler_cfg = ResamplerConfig(
                    dim=lat[-1], depth=len(proj["layers"]), dim_head=64, heads=heads,
                    num_queries=lat[-2], embedding_dim=np.shape(proj["proj_in"]["w"])[0],
                    output_dim=np.shape(proj["proj_out"]["w"])[1])
        elif resampler_cfg is None:
            # random weights must give tokens of this UNet's cross dim, whatever its config
            resampler_cfg = dataclasses.replace(self._default_resampler_cfg(),
                                                output_dim=cross_dim)
        if plus:
            head = functools.partial(Resampler, resampler_cfg)
        elif proj is not None:
            rows, cols = np.shape(proj["proj"]["w"])
            n = cols // np.shape(proj["norm"]["scale"])[0]
            head = functools.partial(ImageProjection, rows, cols // n, n)
        else:
            head = functools.partial(ImageProjection, encoder_cfg.projection_dim, cross_dim)

        def build(factory, tree, kind):
            return build_module(factory, tree, kind, self.device, self.dtype, gen)

        self.ip_encoder = build(functools.partial(CLIPVision, encoder_cfg), encoder_params,
                                "clip_vision")
        self.ip_proj = build(head, proj, "ip_proj")
        insert_ip_into_unet(self.unet, [
            [build(lambda: IPProjection(attn.to_k.in_features, attn.to_q.out_features), w,
                   "unet") for w in site]
            for attn, site in zip(attn2_modules(self.unet), ip_weights)])
        self._ip = {"scale": scale, "plus": plus, "encoder_cfg": encoder_cfg,
                    "resampler_cfg": resampler_cfg}
        # the uncond tokens: zeros in CLIP-normalised space (diffusers' encode_image zeroes the
        # preprocessed pixel_values, not the image), computed once
        size = encoder_cfg.image_size
        zero = torch.zeros((1, 3, size, size), dtype=self.dtype, device=self.device)
        self._ip_uncond = self._ip_tokens(zero)

    def _auto_enable_ip(self):
        """Called by the score paths when ip_adapter=True and nothing is attached: random
        weights keep throughput and test runs working, but the scores are meaningless; say so."""
        if self._ip is None:
            print("[ip_adapter] no adapter attached: enabling RANDOM weights; scores are "
                  "meaningless. Call enable_ip_adapter(converted) with convert_ip_adapter's "
                  "output for real IP-Adapter scoring.")
            self.enable_ip_adapter()

    def _ip_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """CLIP-normalised pixels (B, 3, S, S) in the scorer's dtype -> adapter tokens."""
        if self._ip["plus"]:
            return self.ip_proj(self.ip_encoder.penultimate(x))
        return self.ip_proj(self.ip_encoder(x)["image_embeds"])

    def _ip_embed(self, pix: torch.Tensor) -> torch.Tensor:
        """[-1, 1] pixels (B, 3, H, W) at the scoring resolution -> adapter tokens (B, T, D).
        The reference feeds the original image through CLIPImageProcessor; the scorers resize
        the scoring-resolution pixels on the device (``readout.resize_bilinear``, as the JAX
        package does: its documented divergence)."""
        x = readout.resize_bilinear(pix, self._ip["encoder_cfg"].image_size)
        mean, std = (torch.as_tensor(c, device=x.device)[None, :, None, None]
                     for c in (CLIP_MEAN, CLIP_STD))
        return self._ip_tokens((((x + 1.0) / 2.0 - mean) / std).to(self.dtype))

    def _ip_args(self, pix: torch.Tensor, P: int) -> dict:
        """The UNet's IP arguments for the role-major pixels (2P, 3, H, W) of P pairs, placed
        where the CFG interleave puts each image's rows."""
        cond = self._ip_embed(pix)
        cond = cond.reshape((2, P) + cond.shape[1:]).transpose(0, 1)
        return {"ip_embeds": [self._interleave_ip_embeds(cond, self._ip_uncond, self.cfg_parity,
                                                         self.dtype)],
                "ip_scale": [self._ip["scale"]]}

    @staticmethod
    def _interleave_ip_embeds(cond, ip_uncond, cfg_parity: bool, dtype):
        """(P, n_img, T, D) per-image cond tokens -> the UNet batch's ip_embeds, matching the
        CFG interleave of the latents and the text context: per image [uncond, cond] with
        ``cfg_parity`` ([a_u, a_c, b_u, b_c, ...]), else the cond tokens alone."""
        P, n_img, t_tok, d_tok = cond.shape
        if cfg_parity:
            inter = torch.stack([ip_uncond.expand(cond.shape).to(cond.dtype), cond], dim=2)
            return inter.reshape(P * n_img * 2, t_tok, d_tok).to(dtype)
        return cond.reshape(P * n_img, t_tok, d_tok).to(dtype)
