"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper counts its launches in an integer attribute ``<wrapper>.launches``;
:func:`launch_counts` and :func:`reset_launch_counts` read and clear them all. K1 and K4 also count
the launches that took their ``bf16_probs`` mode (:func:`bf16_probs_launch_counts`).
"""

from __future__ import annotations

from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention
from diffsim_tpu_torch.ops.kernels.attention_stream import streaming_self_attention
from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff
from diffsim_tpu_torch.ops.kernels.readout import cross_self_partials

WRAPPERS = {"fused_self_attention": fused_self_attention, "fused_geglu_ff": fused_geglu_ff,
            "cross_self_partials": cross_self_partials,
            "streaming_self_attention": streaming_self_attention}


# the wrappers with a bf16_probs mode, which also count the launches that took it
BF16_PROBS = ("fused_self_attention", "streaming_self_attention")


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def bf16_probs_launch_counts() -> dict[str, int]:
    return {name: WRAPPERS[name].launches_bf16_probs for name in BF16_PROBS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for name in BF16_PROBS:
        WRAPPERS[name].launches_bf16_probs = 0
