"""First-class attention feature taps.

A tap is part of the model's signature: models take an optional :class:`TapSpec` and
return ``(output, taps)`` where ``taps`` is a dict of tensors. The selected attention layer
emits its tensors with zero recompute, and every other layer contributes nothing. In the
port the UNet also stops at the tap site (eager PyTorch has no dead-code elimination).

The port's own copy of ``diffsim_tpu/ops/taps.py``.
"""

from __future__ import annotations

import dataclasses

# capture modes
QKV = "qkv"  # taps = {'q','k','v'}: (B, heads, seq, head_dim)
OUTPUT = "output"  # taps = {'out'}: post out-proj hidden states (diffeats / *feats variants)
IP_QKV = "ip_qkv"  # taps = {'q','ip_k','ip_v'}: per-adapter K/V lists from to_k_ip/to_v_ip


@dataclasses.dataclass(frozen=True)
class TapSpec:
    """Address of one attention site plus what to capture there.

    ``block``   'down' | 'mid' | 'up' for UNets, 'blocks' for DiT/ViT towers.
    ``address`` backbone-specific static index tuple; see each model's docstring.
    ``attn``    'attn1' (self) or 'attn2' (cross / IP image-cross).
    ``capture`` one of QKV / OUTPUT / IP_QKV.
    """

    block: str
    address: tuple
    attn: str = "attn1"
    capture: str = QKV

