"""CLIP text encoders (the SD-1.5 ViT-L/14 text tower; SDXL adds OpenCLIP bigG), on the math
path.

Counterpart of ``diffsim_tpu/models/clip_text.py``: the causal 77-token encoder. SD-1.5 takes the
final-LN ``last_hidden_state``; SDXL takes the penultimate hidden state of both towers
(``output_hidden_states``: the list before the final LayerNorm) and tower 2's projected pooled
EOS embedding.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from diffsim_tpu_torch.ops.attention import merge_heads, split_heads
from diffsim_tpu_torch.ops.blocks import LayerNorm, gelu, quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 77
    act: str = "quick_gelu"
    eps: float = 1e-5
    projection_dim: int | None = None  # set => a text_projection (SDXL tower 2)

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sdxl_big_g() -> "CLIPTextConfig":
        return CLIPTextConfig(hidden=1280, layers=32, heads=20, intermediate=5120, act="gelu",
                              projection_dim=1280)

    @staticmethod
    def tiny(vocab_size: int = 1000) -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=vocab_size, hidden=32, layers=2, heads=2, intermediate=64)


class _CausalAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(hidden, hidden)
        self.k = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x):
        s = x.shape[1]
        q, k, v = (split_heads(proj(x), self.heads) for proj in (self.q, self.k, self.v))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(weights.float(), v.float()).to(v.dtype)
        return self.out(merge_heads(out))


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.hidden, cfg.eps)
        self.attn = _CausalAttention(cfg.hidden, cfg.heads)
        self.norm2 = LayerNorm(cfg.hidden, cfg.eps)
        self.fc1 = nn.Linear(cfg.hidden, cfg.intermediate)
        self.fc2 = nn.Linear(cfg.intermediate, cfg.hidden)
        self.act = quick_gelu if cfg.act == "quick_gelu" else gelu

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden))
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_positions, cfg.hidden))
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.layers))
        self.final_norm = LayerNorm(cfg.hidden, cfg.eps)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, 77) -> last_hidden_state (B, 77, hidden), after the final LayerNorm."""
        return self.encode(input_ids)["last_hidden_state"]

    def encode(self, input_ids: torch.Tensor, output_hidden_states: bool = False) -> dict:
        """input_ids (B, 77) -> {'last_hidden_state', 'pooled'} plus 'text_embeds' (the
        projected pooled embedding, with a projection) and 'hidden_states' (the embeddings and
        every layer's output, before the final LayerNorm, with ``output_hidden_states``).
        ``pooled`` is the final-LN state at argmax(input_ids): CLIP's EOS pooling (EOS has the
        largest id of both CLIP vocabularies)."""
        x = self.token_embedding[input_ids] + self.position_embedding[None, : input_ids.shape[1]]
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x)
            hidden_states.append(x)
        last = self.final_norm(x)
        pooled = last[torch.arange(last.shape[0], device=last.device), input_ids.argmax(dim=-1)]
        out = {"last_hidden_state": last, "pooled": pooled}
        if self.cfg.projection_dim is not None:
            out["text_embeds"] = self.text_projection(pooled)
        if output_hidden_states:
            out["hidden_states"] = hidden_states
        return out
