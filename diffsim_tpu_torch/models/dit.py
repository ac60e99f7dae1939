"""DiT (Diffusion Transformer) family, DiT-{S,B,L,XL}/{2,4,8}, with adaLN-Zero conditioning.

Counterpart of ``diffsim_tpu/models/dit.py``, for scoring and for training: label dropout
(a ``drop`` mask, which the trainer draws from its generator), ``remat`` (each block under
``torch.utils.checkpoint``) and :meth:`DiT.init_weights` (``dit.init``). The sampler's
classifier-free guidance lives in ``train/dit_trainer.py``, as in the JAX package, which calls no
``forward_with_cfg``. Latents are NCHW, as in the port's UNet. The patch embedding is an ``nn.Linear`` over
flattened patches in (ph, pw, C) feature order (:func:`patchify`), the JAX package's dense
layout, so the weight bridge maps it by its dense rule; the published checkpoint's strided
``Conv2d`` kernel is flattened to it by ``convert/torch_import._patch_conv_to_dense``.

``forward`` returns ``(out, taps)``. The tap address is ``(layer,)`` over ``blocks`` (negative
counts from the end). The JAX scorer relies on XLA's dead-code elimination to stop after the tap;
eager PyTorch has none, so with a tap the forward runs blocks ``0..L-1`` whole and of block ``L``
only its adaLN, modulation and ``qkv`` projection, and returns ``(None, taps)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffsim_tpu_torch.ops.attention import sdpa
from diffsim_tpu_torch.ops.blocks import TimeMLP, silu, timestep_embedding
from diffsim_tpu_torch.ops.taps import QKV, TapSpec


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden: int = 1152
    depth: int = 28
    heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    learn_sigma: bool = False  # the reference's modelsdit.py default (models.py uses True)

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def tokens_per_side(self) -> int:
        return self.input_size // self.patch_size

    @staticmethod
    def xl2(input_size: int = 32, **kw) -> "DiTConfig":
        return DiTConfig(input_size=input_size, patch_size=2, hidden=1152, depth=28, heads=16, **kw)

    @staticmethod
    def l2(input_size: int = 32, **kw) -> "DiTConfig":
        return DiTConfig(input_size=input_size, patch_size=2, hidden=1024, depth=24, heads=16, **kw)

    @staticmethod
    def b2(input_size: int = 32, **kw) -> "DiTConfig":
        return DiTConfig(input_size=input_size, patch_size=2, hidden=768, depth=12, heads=12, **kw)

    @staticmethod
    def s2(input_size: int = 32, **kw) -> "DiTConfig":
        return DiTConfig(input_size=input_size, patch_size=2, hidden=384, depth=12, heads=6, **kw)

    @staticmethod
    def tiny(input_size: int = 8, **kw) -> "DiTConfig":
        kw.setdefault("num_classes", 10)
        return DiTConfig(input_size=input_size, patch_size=2, hidden=32, depth=2, heads=2, **kw)


def _zoo(hidden, depth, heads, patch):
    def make(input_size: int = 32, **kw) -> DiTConfig:
        return DiTConfig(input_size=input_size, patch_size=patch, hidden=hidden,
                         depth=depth, heads=heads, **kw)

    return make


# DiT model zoo name -> constructor, as the published DiT_models
MODELS = {
    f"DiT-{name}/{patch}": _zoo(hidden, depth, heads, patch)
    for (name, hidden, depth, heads) in [
        ("XL", 1152, 28, 16), ("L", 1024, 24, 16), ("B", 768, 12, 12), ("S", 384, 12, 6)
    ]
    for patch in (2, 4, 8)
}


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / (10000.0 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)))
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_embed_2d(dim: int, grid_size: int) -> np.ndarray:
    """Fixed 2D sin-cos position table, (grid * grid, dim) float32, in the published DiT layout
    (the w-coordinate embedding first, sin before cos)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # [0]: w varies fastest, [1]: h
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb = np.concatenate([_sincos_1d(dim // 2, grid[0]), _sincos_1d(dim // 2, grid[1])], axis=1)
    return emb.astype(np.float32)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NCHW (B, C, H, W) -> (B, N, patch * patch * C): row-major patches, each flattened in
    (ph, pw, C) order, the JAX package's layout."""
    b, c, hh, ww = x.shape
    gh, gw = hh // patch, ww // patch
    x = x.reshape(b, c, gh, patch, gw, patch).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, gh * gw, patch * patch * c)


def unpatchify(x: torch.Tensor, patch: int, out_channels: int) -> torch.Tensor:
    """(B, N, patch * patch * C) in (ph, pw, C) feature order -> NCHW (B, C, H, W)."""
    b, n, _ = x.shape
    g = int(round(n**0.5))
    x = x.reshape(b, g, g, patch, patch, out_channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, out_channels, g * patch, g * patch)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, eps 1e-6, computed in float32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class DiTAttention(nn.Module):
    """Fused-qkv self-attention (q/k norms are Identity in the published configs)."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x, *, capture=None):
        b, n, c = x.shape
        # one permute to (3, B, heads, N, hd) and one copy: q, k and v are each contiguous,
        # as K1 takes them
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        if capture == QKV:
            return None, {"q": q, "k": k, "v": v}
        if capture is not None:
            raise NotImplementedError(f"capture {capture!r}: DiT's attention taps QKV only, "
                                      "as the JAX _dit_attention does")
        out = sdpa(q, k, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out), {}


class DiTMlp(nn.Module):
    def __init__(self, hidden: int, mlp_hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_hidden)
        self.fc2 = nn.Linear(mlp_hidden, hidden)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """adaLN-Zero block: LayerNorm (no affine, eps 1e-6) modulated by the conditioning, then
    fused-qkv attention and a GELU-tanh MLP, each gated into the residual."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden
        self.attn = DiTAttention(h, cfg.heads)
        self.mlp = DiTMlp(h, int(h * cfg.mlp_ratio))
        self.adaLN = nn.Linear(h, 6 * h)

    def forward(self, x, c_emb, *, capture=None):
        mod = self.adaLN(silu(c_emb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        h, taps = self.attn(_modulate(_layer_norm(x), shift_msa, scale_msa), capture=capture)
        if h is None:
            return None, taps
        x = x + gate_msa[:, None, :] * h
        y = self.mlp(_modulate(_layer_norm(x), shift_mlp, scale_mlp))
        return x + gate_mlp[:, None, :] * y, taps


class FinalLayer(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden
        self.adaLN = nn.Linear(h, 2 * h)
        self.linear = nn.Linear(h, cfg.patch_size * cfg.patch_size * cfg.out_channels)

    def forward(self, x, c_emb):
        shift, scale = self.adaLN(silu(c_emb)).chunk(2, dim=-1)
        return self.linear(_modulate(_layer_norm(x), shift, scale))


def _checkpointed(blk: nn.Module, h, c_emb):
    """``blk(h, c_emb)`` under non-reentrant checkpointing, with the block's parameters as
    they are at the forward passed in as inputs: the recompute in the backward then runs on the
    same tensors, also when the forward ran under ``torch.func.functional_call`` (the trainer's
    bf16 view), whose parameters are gone from the module by then."""
    named = list(blk.named_parameters())
    names = [n for n, _ in named]

    def run(h, c_emb, *tensors):
        return torch.func.functional_call(blk, dict(zip(names, tensors)), (h, c_emb))

    return checkpoint(run, h, c_emb, *(t for _, t in named), use_reentrant=False)


class DiT(nn.Module):
    """The DiT backbone. Parameter names follow the JAX tree (``patch_embed``, ``pos_embed``,
    ``t_embedder``, ``y_embedder``, ``blocks``, ``final``); ``pos_embed`` (N, hidden) and
    ``y_embedder`` (num_classes + 1, hidden) are tables, the last row of ``y_embedder`` the
    null class."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.patch_embed = nn.Linear(cfg.patch_size * cfg.patch_size * cfg.in_channels, h)
        self.pos_embed = nn.Parameter(torch.empty(cfg.tokens_per_side ** 2, h))
        self.t_embedder = TimeMLP(256, h)
        self.y_embedder = nn.Parameter(torch.empty(cfg.num_classes + 1, h))
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.final = FinalLayer(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DiT":
        """Fill the parameters in place from ``generator``, as ``dit.init`` does: weights and the
        ``y_embedder`` table N(0, 0.02), biases zero, ``pos_embed`` the fixed sin-cos table."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)
        table = pos_embed_2d(self.cfg.hidden, self.cfg.tokens_per_side)
        self.pos_embed.copy_(torch.from_numpy(table))
        return self

    def forward(self, x: torch.Tensor, t, y: torch.Tensor, tap: TapSpec | None = None, *,
                drop: torch.Tensor | None = None, remat: bool = False):
        """x (B, C, H, W) latents, t (B,) or a scalar timestep, y (B,) class labels ->
        ``(out (B, out_channels, H, W), {})``, or ``(None, taps)`` with a tap on ``blocks``.

        ``drop`` is training's label dropout, a boolean (B,) mask (the trainer draws it with
        probability ``class_dropout_prob``): where it is true the label becomes the null class,
        the last row of ``y_embedder``. ``remat=True`` runs each block under
        ``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes its activations;
        the numbers are unchanged."""
        cfg = self.cfg
        b = x.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.dim() == 0:
            t = t.expand(b)
        h = self.patch_embed(patchify(x, cfg.patch_size)) + self.pos_embed[None]
        c_emb = self.t_embedder(timestep_embedding(t, 256).to(h.dtype))
        if drop is not None:
            y = torch.where(drop, cfg.num_classes, y)
        c_emb = c_emb + self.y_embedder[y]
        tap_at = None
        if tap is not None and tap.block == "blocks":
            tap_at = tap.address[0] % cfg.depth
        for i, blk in enumerate(self.blocks):
            capture = tap.capture if i == tap_at else None
            if remat and capture is None:
                h, taps = _checkpointed(blk, h, c_emb)
            else:
                h, taps = blk(h, c_emb, capture=capture)
            if h is None:
                return None, taps
        out = self.final(h, c_emb)
        return unpatchify(out, cfg.patch_size, cfg.out_channels), {}
