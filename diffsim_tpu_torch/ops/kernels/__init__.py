"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper counts its launches in an integer attribute ``<wrapper>.launches``;
:func:`launch_counts` and :func:`reset_launch_counts` read and clear them all.
"""

from __future__ import annotations

from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention
from diffsim_tpu_torch.ops.kernels.attention_stream import streaming_self_attention
from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff
from diffsim_tpu_torch.ops.kernels.readout import cross_self_partials

WRAPPERS = {"fused_self_attention": fused_self_attention, "fused_geglu_ff": fused_geglu_ff,
            "cross_self_partials": cross_self_partials,
            "streaming_self_attention": streaming_self_attention}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
