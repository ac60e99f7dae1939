"""Segment Anything (SAM), promptable segmentation, on PyTorch: the mask source of
``--use_mask --sam_weights``.

Counterpart of ``diffsim_tpu/models/sam.py``, in its NHWC layout and with its parameter names
(the bridge's ``sam`` kind fills these modules from the JAX tree). Three parts, as in the
published checkpoints:

* ``image_encoder``: ViT-{B,L,H}/16 at 1024 x 1024, windowed attention (window 14, the 64 x 64
  grid padded to 70) except a few global layers, decomposed relative positions added to the
  attention logits, and a neck of two convolutions with channel LayerNorms to 256 channels ->
  (B, 64, 64, 256) embeddings;
* ``prompt_encoder``: the random-Fourier encoding of point prompts plus per-role embeddings and
  the dense ``no_mask`` embedding (the mask-prompt stack's weights are loaded, not run);
* ``mask_decoder``: the IoU token and 4 mask tokens through a depth-2 two-way transformer, the
  2x2 transposed-convolution upscaling, per-token hypernetwork MLPs -> (B, 4, 256, 256) mask
  logits and IoU predictions.

Attention runs on the math path, einsum + softmax, as in JAX: the encoder adds its relative
positions to the logits, which K1 does not take. Every product is a float32 matmul, the
convolutions included (products over unfolded patches; the transposed convolution is the JAX
package's einsum), so cuDNN's TF32 default reaches no part of SAM and the card keeps full
float32, as ``torch.backends.cuda.matmul.allow_tf32`` is off by default. ``gelu`` is the exact
erf form.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class SamConfig:
    image_size: int = 1024
    patch: int = 16
    encoder_dim: int = 768
    encoder_depth: int = 12
    encoder_heads: int = 12
    global_attn: tuple = (2, 5, 8, 11)
    window: int = 14
    prompt_dim: int = 256
    decoder_heads: int = 8
    decoder_depth: int = 2
    decoder_mlp: int = 2048
    num_mask_tokens: int = 4  # 1 "single" + 3 multimask outputs

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @staticmethod
    def vit_b() -> "SamConfig":
        return SamConfig()

    @staticmethod
    def vit_l() -> "SamConfig":
        return SamConfig(encoder_dim=1024, encoder_depth=24, encoder_heads=16,
                         global_attn=(5, 11, 17, 23))

    @staticmethod
    def vit_h() -> "SamConfig":
        return SamConfig(encoder_dim=1280, encoder_depth=32, encoder_heads=16,
                         global_attn=(7, 15, 23, 31))

    @staticmethod
    def tiny() -> "SamConfig":
        """CPU-test scale: 32 px input, 4 x 4 token grid, window 2, one global layer."""
        return SamConfig(image_size=32, patch=8, encoder_dim=16, encoder_depth=2,
                         encoder_heads=2, global_attn=(1,), window=2, prompt_dim=16,
                         decoder_heads=2, decoder_mlp=32)


# SAM's pixel normalisation (after the longest-side resize, before the zero pad)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class Conv(nn.Module):
    """A convolution over NHWC activations as one float32 product over unfolded patches. The
    weight keeps ``nn.Conv2d``'s (out, in, kh, kw) layout; ``padding`` is zero padding on each
    side (the JAX "SAME" of the neck's 3 x 3 is 1)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        b, h, w, _ = x.shape
        k = self.weight.shape[-1]
        oh = (h + 2 * self.padding - k) // self.stride + 1
        ow = (w + 2 * self.padding - k) // self.stride + 1
        cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=self.padding, stride=self.stride)
        y = cols.transpose(1, 2) @ self.weight.reshape(self.weight.shape[0], -1).t()
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(b, oh, ow, -1)


class ConvTranspose(nn.Module):
    """The 2 x 2 stride-2 transposed convolution: every input pixel paints a 2 x 2 output block,
    one product over the input channels (the JAX ``_conv_transpose`` einsum). The weight keeps
    ``nn.ConvTranspose2d``'s (in, out, kh, kw) layout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        b, h, w, _ = x.shape
        y = torch.einsum("bijc,copq->bipjqo", x, self.weight)
        return y.reshape(b, 2 * h, 2 * w, -1) + self.bias


def _resize_linear(table: torch.Tensor, length: int) -> torch.Tensor:
    """``jax.image.resize(table, (length, D), "linear")`` on the first axis: the triangle kernel
    at half-pixel centres, widened by the scale when it shrinks (antialiased), each output's
    weights normalised over the rows inside the table. ``F.interpolate(mode="linear")`` matches
    it when growing only."""
    n = table.shape[0]
    scale = length / n
    sample = (torch.arange(length, dtype=torch.float32) + 0.5) / scale - 0.5
    width = max(1.0 / scale, 1.0)
    w = (1.0 - (sample[:, None] - torch.arange(n, dtype=torch.float32)[None, :]).abs()
         / width).clamp_min(0.0)
    w = w / w.sum(dim=1, keepdim=True)
    return w.to(table.device) @ table


def get_rel_pos(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(size, size, head_dim) relative-position terms for q_size == k_size == size from a
    (2 * size - 1, head_dim) table, linearly resized (in float32) if the stored table has
    another length (SAM's get_rel_pos interpolation)."""
    max_rel = 2 * size - 1
    if rel_pos.shape[0] != max_rel:
        rel_pos = _resize_linear(rel_pos.float(), max_rel).to(rel_pos.dtype)
    idx = torch.arange(size)[:, None] - torch.arange(size)[None, :] + (size - 1)
    return rel_pos[idx.to(rel_pos.device)]


class EncoderAttention(nn.Module):
    """SAM encoder attention over (B, H, W, C), decomposed relative positions added to the
    logits, on the math path. A global layer at 1024 px holds (B, heads, 4096, 4096) logits."""

    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * size - 1, dim // heads))

    def forward(self, x):
        b, h, w, c = x.shape
        heads, hd = self.heads, c // self.heads
        qkv = self.qkv(x.reshape(b, h * w, c))
        q, k, v = qkv.reshape(b, h * w, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        logits = torch.matmul(q, k.transpose(-1, -2)).mul_(hd ** -0.5)
        r_q = q.reshape(b, heads, h, w, hd)
        rel_h = torch.einsum("bnhwd,hkd->bnhwk", r_q, get_rel_pos(h, self.rel_pos_h))
        rel_w = torch.einsum("bnhwd,wkd->bnhwk", r_q, get_rel_pos(w, self.rel_pos_w))
        logits.view(b, heads, h, w, h, w).add_(rel_h[..., :, None]).add_(rel_w[..., None, :])
        weights = logits.softmax(dim=-1)
        del logits
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, h, w, c)
        return self.proj(out)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: SamConfig, windowed: bool):
        super().__init__()
        d = cfg.encoder_dim
        self.window = cfg.window if windowed else 0
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = EncoderAttention(d, cfg.encoder_heads, cfg.window if windowed else cfg.grid)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _MLP(d, 4 * d)

    def forward(self, x):
        h = self.norm1(x)
        if self.window:
            h, pad_hw = window_partition(h, self.window)
            h = window_unpartition(self.attn(h), self.window, pad_hw, x.shape[1:3])
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


def window_partition(x, win: int):
    """(B, H, W, C) -> (B * windows, win, win, C), the grid zero-padded bottom and right to a
    multiple of ``win`` (64 -> 70 at 1024 px: 25 windows of 14 x 14); and the padded size."""
    b, h, w, c = x.shape
    ph, pw = (-h) % win, (-w) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def window_unpartition(x, win: int, pad_hw, hw):
    """The inverse of :func:`window_partition`, the padding cropped off."""
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp // win * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class _Neck(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.conv1 = Conv(dim, out, 1, bias=False)
        self.ln1 = nn.LayerNorm(out, eps=1e-6)
        self.conv2 = Conv(out, out, 3, padding=1, bias=False)
        self.ln2 = nn.LayerNorm(out, eps=1e-6)

    def forward(self, x):
        return self.ln2(self.conv2(self.ln1(self.conv1(x))))


class ImageEncoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.encoder_dim
        self.patch_embed = Conv(3, d, cfg.patch, stride=cfg.patch)
        self.pos_embed = nn.Parameter(torch.empty(cfg.grid, cfg.grid, d))
        self.blocks = nn.ModuleList(EncoderBlock(cfg, i not in cfg.global_attn)
                                    for i in range(cfg.encoder_depth))
        self.neck = _Neck(d, cfg.prompt_dim)

    def forward(self, pixels):
        """pixels (B, S, S, 3), SAM-normalised -> (B, grid, grid, prompt_dim) embeddings."""
        x = self.patch_embed(pixels) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.neck(x)


class _MaskDownscaling(nn.Module):
    """The mask-prompt stack's parameters, held for the checkpoints' strict load: no path of
    either package prompts with a mask."""

    def __init__(self, pd: int):
        super().__init__()
        md = max(pd // 64, 1)  # 1 -> md -> 4 md -> pd (SAM: 1 -> 4 -> 16 -> 256)
        self.conv1 = Conv(1, md, 2, stride=2)
        self.ln1 = nn.LayerNorm(md, eps=1e-6)
        self.conv2 = Conv(md, 4 * md, 2, stride=2)
        self.ln2 = nn.LayerNorm(4 * md, eps=1e-6)
        self.conv3 = Conv(4 * md, pd, 1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        pd = cfg.prompt_dim
        self.image_size = cfg.image_size
        # PositionEmbeddingRandom's gaussian matrix, unscaled (the checkpoints bake in scale 1)
        self.pe_gaussian = nn.Parameter(torch.empty(2, pd // 2))
        # 0: negative point, 1: positive point, 2: box top-left, 3: box bottom-right
        self.point_embeddings = nn.ParameterList(nn.Parameter(torch.empty(pd)) for _ in range(4))
        self.not_a_point = nn.Parameter(torch.empty(pd))
        self.no_mask = nn.Parameter(torch.empty(pd))
        self.mask_downscaling = _MaskDownscaling(pd)

    def pe_encode(self, coords):
        """coords (..., 2) in [0, 1] -> (..., prompt_dim) random-Fourier features."""
        g = self.pe_gaussian
        c = 2.0 * math.pi * ((2.0 * coords.to(g.dtype) - 1.0) @ g)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def dense_pe(self, grid: int):
        """(grid, grid, prompt_dim) positional encoding of the image-embedding grid."""
        t = (torch.arange(grid, dtype=self.pe_gaussian.dtype, device=self.pe_gaussian.device)
             + 0.5) / grid
        ys, xs = torch.meshgrid(t, t, indexing="ij")
        return self.pe_encode(torch.stack([xs, ys], dim=-1))  # (g, g, 2) = (x, y)

    def encode_points(self, coords, labels):
        """coords (B, N, 2) pixel xy in [0, image_size); labels (B, N) 1 = fg, 0 = bg, -1 = pad,
        2 / 3 = box corners -> (B, N + 1, prompt_dim). A padding point (label -1) is appended,
        as SAM does when no box prompt comes with the points."""
        b = coords.shape[0]
        coords = torch.cat([coords, coords.new_zeros(b, 1, 2)], dim=1)
        labels = torch.cat([labels, labels.new_full((b, 1), -1)], dim=1)
        pe = self.pe_encode((coords.to(self.pe_gaussian.dtype) + 0.5) / self.image_size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point.to(pe.dtype), pe)
        for role, table in enumerate(self.point_embeddings):
            emb = torch.where(lab == role, pe + table.to(pe.dtype), emb)
        return emb


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, internal: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, internal)
        self.k = nn.Linear(dim, internal)
        self.v = nn.Linear(dim, internal)
        self.out = nn.Linear(internal, dim)

    def forward(self, q_in, k_in, v_in):
        q, k, v = self.q(q_in), self.k(k_in), self.v(v_in)
        b, nq, c = q.shape
        hd = c // self.heads
        q = q.reshape(b, nq, self.heads, hd).transpose(1, 2)
        k = k.reshape(b, k.shape[1], self.heads, hd).transpose(1, 2)
        v = v.reshape(b, v.shape[1], self.heads, hd).transpose(1, 2)
        w = (torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)).softmax(dim=-1)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, nq, c)
        return self.out(out)


class TwoWayLayer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        pd, heads = cfg.prompt_dim, cfg.decoder_heads
        self.self_attn = DecoderAttention(pd, pd, heads)
        self.norm1 = nn.LayerNorm(pd)
        self.cross_t2i = DecoderAttention(pd, pd // 2, heads)
        self.norm2 = nn.LayerNorm(pd)
        self.mlp = _MLP(pd, cfg.decoder_mlp)
        self.norm3 = nn.LayerNorm(pd)
        self.cross_i2t = DecoderAttention(pd, pd // 2, heads)
        self.norm4 = nn.LayerNorm(pd)


class _MLP3(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim)
        self.fc2 = nn.Linear(dim, dim)
        self.fc3 = nn.Linear(dim, out)

    def forward(self, x):
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class _Upscale(nn.Module):
    def __init__(self, pd: int):
        super().__init__()
        self.convt1 = ConvTranspose(pd, pd // 4)
        self.ln = nn.LayerNorm(pd // 4, eps=1e-6)
        self.convt2 = ConvTranspose(pd // 4, pd // 8)

    def forward(self, x):
        return F.gelu(self.convt2(F.gelu(self.ln(self.convt1(x)))))


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        pd, n_tok = cfg.prompt_dim, cfg.num_mask_tokens
        self.iou_token = nn.Parameter(torch.empty(pd))
        self.mask_tokens = nn.Parameter(torch.empty(n_tok, pd))
        self.layers = nn.ModuleList(TwoWayLayer(cfg) for _ in range(cfg.decoder_depth))
        self.final_attn = DecoderAttention(pd, pd // 2, cfg.decoder_heads)
        self.norm_final = nn.LayerNorm(pd)
        self.upscale = _Upscale(pd)
        self.hyper_mlps = nn.ModuleList(_MLP3(pd, pd // 8) for _ in range(n_tok))
        self.iou_head = _MLP3(pd, n_tok)

    def forward(self, image_embed, image_pe, sparse_prompt):
        """image_embed (B, g, g, pd), image_pe (g, g, pd), sparse_prompt (B, N, pd) ->
        (mask_logits (B, n_tokens, 4g, 4g) float32, iou_pred (B, n_tokens)). The two-way
        transformer adds the original tokens and the image positions back at every attention;
        layer 0's self-attention replaces the queries (the published skip_first_layer_pe
        block has no residual there)."""
        b, g, _, pd = image_embed.shape
        tokens0 = torch.cat([self.iou_token[None], self.mask_tokens]).to(image_embed.dtype)
        tokens0 = torch.cat([tokens0.expand(b, -1, -1), sparse_prompt.to(image_embed.dtype)],
                            dim=1)
        queries = tokens0
        keys = image_embed.reshape(b, g * g, pd)
        key_pe = image_pe.reshape(1, g * g, pd).to(keys.dtype)
        for i, layer in enumerate(self.layers):
            if i == 0:
                queries = layer.norm1(layer.self_attn(queries, queries, queries))
            else:
                qq = queries + tokens0
                queries = layer.norm1(queries + layer.self_attn(qq, qq, queries))
            a = layer.cross_t2i(queries + tokens0, keys + key_pe, keys)
            queries = layer.norm2(queries + a)
            m = layer.mlp.fc2(F.relu(layer.mlp.fc1(queries)))
            queries = layer.norm3(queries + m)
            a = layer.cross_i2t(keys + key_pe, queries + tokens0, queries)
            keys = layer.norm4(keys + a)
        a = self.final_attn(queries + tokens0, keys + key_pe, keys)
        queries = self.norm_final(queries + a)

        n_tok = self.mask_tokens.shape[0]
        src = self.upscale(keys.reshape(b, g, g, pd))  # (B, 4g, 4g, pd / 8)
        hyper = torch.stack([mlp(queries[:, 1 + i]) for i, mlp in enumerate(self.hyper_mlps)],
                            dim=1)  # (B, n_tok, pd / 8)
        f32 = torch.promote_types(src.dtype, torch.float32)  # a float64 module stays float64
        masks = torch.einsum("btc,bhwc->bthw", hyper.to(f32), src.to(f32))
        return masks, self.iou_head(queries[:, 0])


class Sam(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def predict(self, pixels, point_coords, point_labels, multimask: bool = True):
        """SamPredictor.predict: SAM-normalised pixels (B, S, S, 3) and point prompts (B, N, 2)
        xy with (B, N) labels -> (mask_logits (B, M, S / 4, S / 4), iou_pred (B, M)), M = 3
        (multimask: tokens 1..3) or 1 (token 0). Binary masks are the logits above 0."""
        embed = self.image_encoder(pixels)
        pe = self.prompt_encoder.dense_pe(self.cfg.grid)
        sparse = self.prompt_encoder.encode_points(point_coords, point_labels)
        dense = self.prompt_encoder.no_mask.to(embed.dtype)
        masks, iou = self.mask_decoder(embed + dense, pe, sparse)
        if multimask:
            return masks[:, 1:], iou[:, 1:]
        return masks[:, :1], iou[:, :1]
