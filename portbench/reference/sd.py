"""Plain PyTorch reference of DiffSim scoring on the Stable Diffusion backbones (SD-1.5, SDXL).

What it computes, from pixels, weights and the scoring arguments alone:

    uint8 pixels -> [-1, 1] -> VAE encoder -> posterior sample (the scoring seed's draws)
    -> q_sample to the tap's timestep -> UNet over the CFG-doubled rows [uncond, cond] of each
    image, stopped once the tap's attention has its Q, K and V -> the cross-image readout:
    cos(attn(Q_A, K_B, V_B), attn(Q_A, K_A, V_A)) and the same for B, averaged.

Every product runs in float32 with TF32 off (:func:`float32_math`). ``precision="fp8"`` is the
control: the same graph with both operands of every product (linear, convolution, attention)
rounded to float8 e4m3 with a per-tensor scale, the step below the bf16 the configurations
state.

Nothing here imports the program under test or JAX. Parameter names follow the published
Stable Diffusion layout (``to_q``, ``norm1``, ``proj_in`` ...), so the benchmark can hand one set
of weights to both sides by name.
"""

from __future__ import annotations

import contextlib
import html
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


@contextlib.contextmanager
def float32_math():
    """Full float32 products: TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """Rounds the operands of every product: ``float32`` leaves them, ``fp8`` rounds each
    tensor to float8 e4m3 after scaling its largest magnitude to :data:`FP8_MAX`."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.name == "float32" or x.device.type == "meta":
            return x
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """The products of the graph, each taking its operands through ``Precision``."""

    def __init__(self, precision: str = "float32"):
        self.q = Precision(precision)

    def linear(self, x, lin: nn.Linear):
        return F.linear(self.q(x), self.q(lin.weight), None if lin.bias is None
                        else lin.bias.float())

    def conv(self, x, conv: nn.Conv2d, stride: int = 1, padding: int = 0):
        return F.conv2d(self.q(x), self.q(conv.weight), conv.bias.float(), stride, padding)

    def attention(self, q, k, v):
        """softmax(q k^T / sqrt(d)) v over (..., S, D)."""
        logits = torch.matmul(self.q(q), self.q(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
        return torch.matmul(self.q(torch.softmax(logits, dim=-1)), self.q(v))


# ---------------------------------------------------------------------------
# modules: parameters only, in the published layout; the arithmetic is in the functions below
# ---------------------------------------------------------------------------


def _norm(c):
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty(c))
    m.bias = nn.Parameter(torch.empty(c))
    return m


def _conv(cin, cout, k):
    return nn.Conv2d(cin, cout, k)


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb=None):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = _conv(cin, cout, 3)
        self.norm2 = _norm(cout)
        self.conv2 = _conv(cout, cout, 3)
        if temb is not None:
            self.time_emb_proj = nn.Linear(temb, cout)
        if cin != cout:
            self.shortcut = _conv(cin, cout, 1)


class Attn(nn.Module):
    def __init__(self, dim, cdim=None, bias=False):
        super().__init__()
        cdim = cdim or dim
        self.to_q = nn.Linear(dim, dim, bias=bias)
        self.to_k = nn.Linear(cdim, dim, bias=bias)
        self.to_v = nn.Linear(cdim, dim, bias=bias)
        self.to_out = nn.Linear(dim, dim)


class FF(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj_in = nn.Linear(dim, 8 * dim)
        self.proj_out = nn.Linear(4 * dim, dim)


class Block(nn.Module):
    def __init__(self, dim, cdim):
        super().__init__()
        self.norm1, self.attn1 = _norm(dim), Attn(dim)
        self.norm2, self.attn2 = _norm(dim), Attn(dim, cdim)
        self.norm3, self.ff = _norm(dim), FF(dim)


class Transformer(nn.Module):
    def __init__(self, c, heads, cdim, depth, linear_proj):
        super().__init__()
        self.heads, self.linear_proj = heads, linear_proj
        self.norm = _norm(c)
        self.proj_in = nn.Linear(c, c) if linear_proj else _conv(c, c, 1)
        self.blocks = nn.ModuleList(Block(c, cdim) for _ in range(depth))
        self.proj_out = nn.Linear(c, c) if linear_proj else _conv(c, c, 1)


class Level(nn.Module):
    def __init__(self, resnets, attentions, resample=None, name="downsample"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if resample is not None:
            self.add_module(name, resample)


class TimeMLP(nn.Module):
    def __init__(self, din, dout):
        super().__init__()
        self.fc1 = nn.Linear(din, dout)
        self.fc2 = nn.Linear(dout, dout)


class UNet(nn.Module):
    """UNet2DConditionModel's parameters for a config dict with the keys of the benchmark's
    configuration files (``block_out_channels``, ``cross_attn_blocks``, ``layers_per_block``,
    ``transformer_depth``, ``mid_transformer_depth``, ``heads``, ``cross_attention_dim``,
    ``linear_proj``, ``norm_eps``, ``addition_embed`` ...)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = cfg["block_out_channels"]
        ted = 4 * ch[0]
        cdim = cfg["cross_attention_dim"]
        self.time_embedding = TimeMLP(ch[0], ted)
        if cfg.get("addition_embed") == "text_time":
            self.add_embedding = TimeMLP(cfg["projection_class_embeddings_input_dim"], ted)
        self.conv_in = _conv(cfg["in_channels"], ch[0], 3)
        lpb = cfg["layers_per_block"]

        def tr(c, i):
            return Transformer(c, cfg["heads"][i], cdim, cfg["transformer_depth"][i],
                               cfg["linear_proj"])

        down, skips, cin = [], [ch[0]], ch[0]
        for i, cout in enumerate(ch):
            rs, ats = [], []
            for j in range(lpb):
                rs.append(Resnet(cin if j == 0 else cout, cout, ted))
                if cfg["cross_attn_blocks"][i]:
                    ats.append(tr(cout, i))
                skips.append(cout)
            last = i == len(ch) - 1
            if not last:
                skips.append(cout)
            down.append(Level(rs, ats, None if last else _conv(cout, cout, 3)))
            cin = cout
        self.down = nn.ModuleList(down)
        cross = [i for i, c in enumerate(cfg["cross_attn_blocks"]) if c]
        mid_heads = cfg["heads"][-1] if cfg["cross_attn_blocks"][-1] else cfg["heads"][max(cross)]
        self.mid = nn.Module()
        self.mid.resnet1 = Resnet(ch[-1], ch[-1], ted)
        self.mid.attentions = nn.ModuleList([Transformer(
            ch[-1], mid_heads, cdim, cfg["mid_transformer_depth"], cfg["linear_proj"])])
        self.mid.resnet2 = Resnet(ch[-1], ch[-1], ted)
        up, rev, cin = [], list(reversed(ch)), ch[-1]
        for i, cout in enumerate(rev):
            di = len(ch) - 1 - i
            rs, ats = [], []
            for j in range(lpb + 1):
                rs.append(Resnet((cin if j == 0 else cout) + skips.pop(), cout, ted))
                if cfg["cross_attn_blocks"][di]:
                    ats.append(tr(cout, di))
            last = i == len(rev) - 1
            up.append(Level(rs, ats, None if last else _conv(cout, cout, 3), "upsample"))
            cin = cout
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(ch[0])
        self.conv_out = _conv(ch[0], cfg["out_channels"], 3)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch = cfg["block_out_channels"]
        self.conv_in = _conv(cfg["in_channels"], ch[0], 3)
        cins = [ch[0]] + list(ch[:-1])
        down = []
        for i, (cin, cout) in enumerate(zip(cins, ch)):
            rs = [Resnet(cin if j == 0 else cout, cout) for j in range(cfg["layers_per_block"])]
            down.append(Level(rs, [], _conv(cout, cout, 3) if i < len(ch) - 1 else None))
        self.down = nn.ModuleList(down)
        self.mid = nn.Module()
        self.mid.resnet1 = Resnet(ch[-1], ch[-1])
        self.mid.attn = Attn(ch[-1], bias=True)
        self.mid.attn.norm = _norm(ch[-1])
        self.mid.resnet2 = Resnet(ch[-1], ch[-1])
        self.norm_out = _norm(ch[-1])
        self.conv_out = _conv(ch[-1], 2 * cfg["latent_channels"], 3)
        self.quant_conv = _conv(2 * cfg["latent_channels"], 2 * cfg["latent_channels"], 1)


class TextLayer(nn.Module):
    def __init__(self, hid, inter):
        super().__init__()
        self.norm1 = _norm(hid)
        self.attn = nn.Module()
        for n in ("q", "k", "v", "out"):
            setattr(self.attn, n, nn.Linear(hid, hid))
        self.norm2 = _norm(hid)
        self.fc1 = nn.Linear(hid, inter)
        self.fc2 = nn.Linear(inter, hid)


class CLIPText(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(cfg["vocab_size"], cfg["hidden"]))
        self.position_embedding = nn.Parameter(torch.empty(cfg["max_positions"], cfg["hidden"]))
        self.layers = nn.ModuleList(TextLayer(cfg["hidden"], cfg["intermediate"])
                                    for _ in range(cfg["layers"]))
        self.final_norm = _norm(cfg["hidden"])
        if cfg.get("projection_dim"):
            self.text_projection = nn.Linear(cfg["hidden"], cfg["projection_dim"], bias=False)


MODULES = {"unet": UNet, "vae": VAEEncoder, "text": CLIPText, "text2": CLIPText}


def module_specs(config: dict) -> dict:
    """{part: module config} of a benchmark configuration: the parts its scorer holds."""
    return {part: config[part] for part in MODULES if part in config}


def build_modules(config: dict, device="meta") -> dict:
    """{part: module} of ``config`` with uninitialised parameters on ``device``."""
    with torch.device(device):
        return {part: MODULES[part](cfg) for part, cfg in module_specs(config).items()}


SILU_SQ = 0.35577551981441646  # E[silu(x)^2] for x ~ N(0, 1)
POSTERIOR_LOGVAR = -10.0  # a trained VAE's posterior is narrow: std e^-5 against a unit mean


def shape_weights(config: dict, weights: dict, std: float) -> None:
    """Give random weights (matrices N(0, ``std``)) the VAE posterior of a trained model, in
    place: the moments' mean channels scaled so that the latent (times ``scaling_factor``) has
    unit variance, and the log-variance biased to ``POSTERIOR_LOGVAR``. Without it the mean is
    a few hundredths and the posterior's std about 1, so the latent is the seed's draw and
    nothing of the image or of the VAE reaches the score."""
    if "vae" not in weights:
        return
    v = config["vae"]
    lat = v["latent_channels"]
    # the std of conv_out's output (3x3 over the last level's GroupNorm + SiLU), then of
    # quant_conv's (1x1 over the 2 * latent moments)
    out_std = std * math.sqrt(9 * v["block_out_channels"][-1] * SILU_SQ)
    mean_std = std * math.sqrt(2 * lat) * out_std
    w = weights["vae"]
    w["quant_conv.weight"][:lat].mul_(1.0 / (v["scaling_factor"] * mean_std))
    w["quant_conv.bias"][lat:].fill_(POSTERIOR_LOGVAR)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def group_norm(x, m, eps, groups=32):
    return F.group_norm(x, groups, m.weight.float(), m.bias.float(), eps)


def layer_norm(x, m, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], m.weight.float(), m.bias.float(), eps)


def heads_split(x, h):
    b, s, c = x.shape
    return x.reshape(b, s, h, c // h).transpose(1, 2)


def heads_merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def resnet(ops, m, x, temb, eps):
    h = ops.conv(F.silu(group_norm(x, m.norm1, eps)), m.conv1, padding=1)
    if temb is not None:
        h = h + ops.linear(F.silu(temb), m.time_emb_proj)[:, :, None, None]
    h = ops.conv(F.silu(group_norm(h, m.norm2, eps)), m.conv2, padding=1)
    if hasattr(m, "shortcut"):
        x = ops.conv(x, m.shortcut)
    return x + h


class Stop(Exception):
    """Raised at the tap with its tensors, which ends the forward there."""

    def __init__(self, taps):
        super().__init__("tap")
        self.taps = taps


def transformer(ops, m, x, ctx, tap=None, sites=None):
    """One spatial transformer. ``tap`` = (transformer block index, 'attn1' | 'attn2'): raise
    :class:`Stop` with that attention's (q, k, v) once they exist. ``sites`` collects the
    (heads, tokens, head dim) of each self-attention that runs."""
    b, c, hh, ww = x.shape
    res = x
    h = group_norm(x, m.norm, 1e-6)
    if m.linear_proj:
        h = ops.linear(h.flatten(2).transpose(1, 2), m.proj_in)
    else:
        h = ops.conv(h, m.proj_in).flatten(2).transpose(1, 2)
    n = len(m.blocks)
    for i, blk in enumerate(m.blocks):
        for name, norm, context in (("attn1", blk.norm1, None), ("attn2", blk.norm2, ctx)):
            a = getattr(blk, name)
            y = layer_norm(h, norm)
            src = y if context is None else context
            q = heads_split(ops.linear(y, a.to_q), m.heads)
            k = heads_split(ops.linear(src, a.to_k), m.heads)
            v = heads_split(ops.linear(src, a.to_v), m.heads)
            if tap is not None and tap[0] % n == i and tap[1] == name:
                raise Stop({"q": q, "k": k, "v": v})
            if sites is not None and context is None:
                sites.append(tuple(q.shape[1:]))
            h = h + ops.linear(heads_merge(ops.attention(q, k, v)), a.to_out)
        hg, gate = ops.linear(layer_norm(h, blk.norm3), blk.ff.proj_in).chunk(2, dim=-1)
        h = h + ops.linear(hg * F.gelu(gate), blk.ff.proj_out)
    if m.linear_proj:
        h = ops.linear(h, m.proj_out).transpose(1, 2).reshape(b, c, hh, ww)
    else:
        h = ops.conv(h.transpose(1, 2).reshape(b, c, hh, ww), m.proj_out)
    return h + res


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal embedding, cosines first (flip_sin_to_cos, no frequency shift)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp(ops, m, x):
    return ops.linear(F.silu(ops.linear(x, m.fc1)), m.fc2)


def unet_to_tap(ops, unet: UNet, x, t, ctx, tap, added=None, sites=None):
    """The UNet's forward up to ``tap`` = (block 'down' | 'mid' | 'up', (level, attention,
    transformer block), 'attn1' | 'attn2'); returns that attention's {'q', 'k', 'v'}, each
    (rows, heads, tokens, head dim). Negative indices count from the end."""
    cfg = unet.cfg
    eps = cfg["norm_eps"]
    tt = torch.full((x.shape[0],), float(t), device=x.device)
    emb = mlp(ops, unet.time_embedding, timestep_embedding(tt, cfg["block_out_channels"][0]))
    if cfg.get("addition_embed") == "text_time":
        tids = added["time_ids"]
        tproj = timestep_embedding(tids.reshape(-1), cfg["addition_time_embed_dim"])
        emb = emb + mlp(ops, unet.add_embedding,
                        torch.cat([added["text_embeds"], tproj.reshape(tids.shape[0], -1)], -1))
    block, (lvl, att, tblk), attn = tap

    def site(kind, i, j, n):
        if kind != block or (kind != "mid" and lvl != i) or att % n != j:
            return None
        return (tblk, attn)

    try:
        h = ops.conv(x, unet.conv_in, padding=1)
        skips = [h]
        for i, lv in enumerate(unet.down):
            for j, rn in enumerate(lv.resnets):
                h = resnet(ops, rn, h, emb, eps)
                if len(lv.attentions):
                    h = transformer(ops, lv.attentions[j], h, ctx,
                                    site("down", i, j, len(lv.attentions)), sites)
                skips.append(h)
            if hasattr(lv, "downsample"):
                h = ops.conv(h, lv.downsample, stride=2, padding=1)
                skips.append(h)
        h = resnet(ops, unet.mid.resnet1, h, emb, eps)
        h = transformer(ops, unet.mid.attentions[0], h, ctx, site("mid", 0, 0, 1), sites)
        h = resnet(ops, unet.mid.resnet2, h, emb, eps)
        for i, lv in enumerate(unet.up):
            for j, rn in enumerate(lv.resnets):
                h = resnet(ops, rn, torch.cat([h, skips.pop()], dim=1), emb, eps)
                if len(lv.attentions):
                    h = transformer(ops, lv.attentions[j], h, ctx,
                                    site("up", i, j, len(lv.attentions)), sites)
            if hasattr(lv, "upsample"):
                h = ops.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"), lv.upsample,
                             padding=1)
    except Stop as s:
        return s.taps
    raise ValueError(f"tap {tap} is not a site of this UNet")


def vae_encode(ops, enc: VAEEncoder, x, vae_sites=None):
    """[-1, 1] pixels (B, 3, H, W) -> moments (B, 2 latent, H / 8, W / 8)."""
    eps = 1e-6
    h = ops.conv(x, enc.conv_in, padding=1)
    for lv in enc.down:
        for rn in lv.resnets:
            h = resnet(ops, rn, h, None, eps)
        if hasattr(lv, "downsample"):
            h = ops.conv(F.pad(h, (0, 1, 0, 1)), lv.downsample, stride=2)
    h = resnet(ops, enc.mid.resnet1, h, None, eps)
    a = enc.mid.attn
    b, c, hh, ww = h.shape
    y = group_norm(h, a.norm, eps).flatten(2).transpose(1, 2)
    q, k, v = (ops.linear(y, p)[:, None] for p in (a.to_q, a.to_k, a.to_v))
    if vae_sites is not None:
        vae_sites.append(tuple(q.shape[1:]))
    y = ops.linear(ops.attention(q, k, v)[:, 0], a.to_out)
    h = h + y.transpose(1, 2).reshape(b, c, hh, ww)
    h = resnet(ops, enc.mid.resnet2, h, None, eps)
    h = ops.conv(F.silu(group_norm(h, enc.norm_out, eps)), enc.conv_out, padding=1)
    return ops.conv(h, enc.quant_conv)


def text_encode(ops, m: CLIPText, ids):
    """Token ids (B, 77) -> {'last' (final LayerNorm), 'penultimate' (the input of the last
    layer), 'pooled' (final-LN state at the first largest id, projected if the tower has a
    projection)}."""
    cfg = m.cfg
    x = m.token_embedding.float()[ids] + m.position_embedding.float()[None, : ids.shape[1]]
    s = ids.shape[1]
    mask = torch.ones((s, s), dtype=torch.bool, device=ids.device).tril()
    act = (lambda z: z * torch.sigmoid(1.702 * z)) if cfg["act"] == "quick_gelu" else F.gelu
    penult = x
    for layer in m.layers:
        penult = x
        y = layer_norm(x, layer.norm1, cfg["eps"])
        q, k, v = (heads_split(ops.linear(y, getattr(layer.attn, n)), cfg["heads"])
                   for n in ("q", "k", "v"))
        logits = torch.matmul(ops.q(q), ops.q(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        o = torch.matmul(ops.q(torch.softmax(logits, -1)), ops.q(v))
        x = x + ops.linear(heads_merge(o), layer.attn.out)
        x = x + ops.linear(act(ops.linear(layer_norm(x, layer.norm2, cfg["eps"]), layer.fc1)),
                           layer.fc2)
    last = layer_norm(x, m.final_norm, cfg["eps"])
    # the position of the first largest id (EOS: the largest id of the vocabulary)
    first_max = ((ids == ids.max(dim=-1, keepdim=True).values).cumsum(-1) == 0).sum(-1)
    pooled = last[torch.arange(ids.shape[0], device=ids.device), first_max]
    if hasattr(m, "text_projection"):
        pooled = ops.linear(pooled, m.text_projection)
    return {"last": last, "penultimate": penult, "pooled": pooled}


# ---------------------------------------------------------------------------
# tokenizer, schedules, noise
# ---------------------------------------------------------------------------


def hash_tokens(texts, vocab_size: int, max_len: int = 77) -> np.ndarray:
    """The word-hash tokenizer of random-weight runs: BOS, one id per lower-cased word (its
    first 8 bytes, little-endian, mod vocab - 2), EOS, EOS padding."""
    bos, eos = vocab_size - 2, vocab_size - 1
    out = np.full((len(texts), max_len), eos, dtype=np.int64)
    for i, t in enumerate(texts):
        t = re.sub(r"\s+", " ", html.unescape(html.unescape(t)).strip()).lower()
        ids = [int.from_bytes(w.encode()[:8].ljust(8, b"\0"), "little") % (vocab_size - 2)
               for w in t.split()]
        ids = [bos] + ids[: max_len - 2] + [eos]
        out[i, : len(ids)] = ids
    return out


def _alphas_cumprod():
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def noise_coefficients(schedule: str, target_step: int) -> tuple[float, float, float]:
    """(model timestep, a, b) with x = a * z + b * eps. ``pndm`` (SD-1.5): the PLMS timestep
    list of 1000 steps [1000, 999, 999, 998, ..., 1] indexed by ``target_step``, DDPM noising at
    min(t, 999). ``euler`` (SDXL): t = 1000 - target_step, the Euler scheduler's input scaling
    and its initial-noise amplification: a = sigma_max' c_in, b = sigma_t c_in."""
    ac = _alphas_cumprod()
    if schedule == "pndm":
        table = np.concatenate([np.arange(1, 1000), [999, 1000]])[::-1]
        t = int(table[target_step])
        a_t = ac[min(t, 999)]
        return float(t), float(np.sqrt(a_t)), float(np.sqrt(1.0 - a_t))
    if schedule == "euler":
        t = 1000 - target_step
        sig = np.sqrt((1.0 - ac) / ac)
        sigma_t = float(np.interp(float(t), np.arange(1000, dtype=np.float64), sig))
        c_in = 1.0 / np.sqrt(sigma_t ** 2 + 1.0)
        init = float(np.sqrt(sig.max() ** 2 + 1.0))
        return float(t), float(init * c_in), float(sigma_t * c_in)
    raise ValueError(f"unknown schedule {schedule!r}")


def role_draws(seed: int, shape, device):
    """The scoring seed's four float32 normal draws of ``shape`` (h, w, C), one generator on
    ``device``, in the order [posterior A, posterior B, noise A, noise B]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            for _ in range(4)]


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------


def tap_of(score: dict) -> tuple:
    """The configuration's tap -> (block, (level, attention, transformer), attn). SD-1.5's
    single layer index L addresses up block L + 1's last attention's last block (down: down
    block L); SDXL's [b, a, t] addresses up block b (down: down block b + 1)."""
    layer = score["target_layer"]
    layer = [layer] if isinstance(layer, int) else list(layer)
    kind = score["target_block"]
    if kind not in ("up_blocks", "down_blocks"):
        raise ValueError(f"no reference for taps in {kind}")
    if len(layer) == 1:
        addr = (layer[0] + 1 if kind == "up_blocks" else layer[0], -1, -1)
    else:
        b, a, t = layer
        addr = (b + 1 if kind == "down_blocks" else b, a, t)
    return ("up" if kind == "up_blocks" else "down"), addr, "attn1"


def flat_cosine(x, y):
    """Per leading row, the cosine of the flattened rest (float64, norms clamped at 1e-8)."""
    x = x.reshape(x.shape[0], -1).double()
    y = y.reshape(y.shape[0], -1).double()
    nx = torch.linalg.vector_norm(x, dim=-1).clamp(min=1e-8)
    ny = torch.linalg.vector_norm(y, dim=-1).clamp(min=1e-8)
    return (x * y).sum(-1) / (nx * ny)


class Reference:
    """DiffSim scores of a configuration (``configs/*.json``) from its weights {part: state
    dict}. ``precision``: ``float32`` (the reference) or ``fp8`` (the control)."""

    def __init__(self, config: dict, weights: dict, device, precision: str = "float32"):
        self.cfg = config
        self.device = torch.device(device)
        self.ops = Ops(precision)
        self.mods = build_modules(config, "meta")
        for part, mod in self.mods.items():
            mod.to_empty(device=self.device)
            mod.load_state_dict({k: v.float() for k, v in weights[part].items()}, strict=True)
            mod.requires_grad_(False)
        sc = config["score"]
        self.tap = tap_of(sc)
        self.t, self.a, self.b = noise_coefficients(config["schedule"], sc["target_step"])
        self.ctx, self.pooled = self._prompt(sc["prompt"])

    @torch.no_grad()
    def _prompt(self, prompt):
        """(2, 77, D) [uncond, cond] context rows and, for SDXL, (2, pooled) pooled rows."""
        vocab = self.cfg["text"]["vocab_size"]
        with float32_math():
            if "text2" not in self.mods:
                ids = torch.from_numpy(hash_tokens(["", prompt], vocab)).to(self.device)
                return text_encode(self.ops, self.mods["text"], ids)["last"], None
            ids = torch.from_numpy(hash_tokens([prompt], vocab)).to(self.device)
            o1 = text_encode(self.ops, self.mods["text"], ids)
            o2 = text_encode(self.ops, self.mods["text2"], ids)
            cond = torch.cat([o1["penultimate"], o2["penultimate"]], dim=-1)
            # the empty negative prompt is all zeros (force_zeros_for_empty_prompt)
            return (torch.cat([torch.zeros_like(cond), cond]),
                    torch.cat([torch.zeros_like(o2["pooled"]), o2["pooled"]]))

    @torch.no_grad()
    def moments(self, pixels_u8: np.ndarray) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> moments (N, 2 latent, h, w), an image at a time."""
        out = []
        with float32_math():
            for img in pixels_u8:
                x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device).float()
                x = (x / 127.5 - 1.0).permute(2, 0, 1)[None]
                out.append(vae_encode(self.ops, self.mods["vae"], x))
        return torch.cat(out)

    @torch.no_grad()
    def image_taps(self, moments: torch.Tensor, role: int) -> dict:
        """One image's moments (2 latent, h, w) -> its tap (2 rows [uncond, cond], heads, S,
        D), with role ``role``'s draws (0: image A, 1: image B)."""
        sc = self.cfg["score"]
        lat = self.cfg["vae"]["latent_channels"]
        h, w = moments.shape[-2:]
        draws = [d.permute(2, 0, 1) for d in role_draws(sc["seed"], (h, w, lat), self.device)]
        mean, logvar = moments.float().chunk(2, dim=0)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        z = (mean + std * draws[role]) * self.cfg["vae"]["scaling_factor"]
        x = (self.a * z + self.b * draws[2 + role])[None].expand(2, -1, -1, -1)
        added = None
        if self.pooled is not None:
            added = {"text_embeds": self.pooled,
                     "time_ids": torch.tensor([self.cfg["score"]["time_ids"]] * 2,
                                              dtype=torch.float32, device=self.device)}
        with float32_math():
            return unet_to_tap(self.ops, self.mods["unet"], x, self.t, self.ctx, self.tap,
                               added)

    @torch.no_grad()
    def readout(self, ta: dict, tb: dict) -> float:
        """The two-direction cross-image cosine of two images' taps."""
        with float32_math():
            qa, ka, va = ta["q"], ta["k"], ta["v"]
            qb, kb, vb = tb["q"], tb["k"], tb["v"]
            at = self.ops.attention
            s = (flat_cosine(at(qa, kb, vb)[None], at(qa, ka, va)[None])
                 + flat_cosine(at(qb, ka, va)[None], at(qb, kb, vb)[None])) / 2.0
        return float(s[0])

    def scores(self, m: torch.Tensor) -> tuple:
        """The moments of a triplet [a, b, c] -> (s_ab, s_ac): A with role A's draws, B and C
        each with role B's; of a pair [a, b] -> (s,)."""
        ta = self.image_taps(m[0], 0)
        return tuple(self.readout(ta, self.image_taps(mb, 1)) for mb in m[1:])

    def triplet(self, pix3: np.ndarray) -> tuple[float, float]:
        """(3, H, W, 3) uint8 [a, b, c] -> (s_ab, s_ac)."""
        return self.scores(self.moments(pix3))

    def pair(self, pix2: np.ndarray) -> float:
        """(2, H, W, 3) uint8 [a, b] -> the pair's score."""
        return self.scores(self.moments(pix2))[0]


# ---------------------------------------------------------------------------
# work, for the per-layer metrics
# ---------------------------------------------------------------------------


def _flops(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@torch.no_grad()
def work_of(config: dict) -> dict:
    """The work of the configuration's calls, counted once per shape over meta tensors:
    {row_flops: one UNet row to the tap, image_flops: one VAE encode, pair_flops: one pair's
    readout (both directions), row_sites and image_sites: (heads, tokens, head dim) of each
    self-attention of a row and of an encode}."""
    mods = build_modules(config, "meta")
    ops = Ops()
    meta = torch.device("meta")
    u, v = config["unet"], config["vae"]
    lat = config["img_size"] // 2 ** (len(v["block_out_channels"]) - 1)
    t, _, _ = noise_coefficients(config["schedule"], config["score"]["target_step"])
    x = torch.empty((2, u["in_channels"], lat, lat), device=meta)
    ctx = torch.empty((2, config["text"]["max_positions"], u["cross_attention_dim"]), device=meta)
    added = None
    if u.get("addition_embed") == "text_time":
        added = {"text_embeds": torch.empty((2, config["text2"]["projection_dim"]), device=meta),
                 "time_ids": torch.empty((2, 6), device=meta)}
    tap = tap_of(config["score"])
    sites, box = [], {}

    def unet():
        box["taps"] = unet_to_tap(ops, mods["unet"], x, t, ctx, tap, added, sites)

    row = _flops(unet) / 2
    q, k, w = box["taps"]["q"], box["taps"]["k"], box["taps"]["v"]
    pair = _flops(lambda: [ops.attention(q, k, w) for _ in range(4)])
    image_sites = []
    img = torch.empty((1, v["in_channels"], config["img_size"], config["img_size"]), device=meta)
    image = _flops(lambda: vae_encode(ops, mods["vae"], img, image_sites))
    return dict(row_flops=row, image_flops=image, pair_flops=pair, row_sites=tuple(sites),
                image_sites=tuple(image_sites))
