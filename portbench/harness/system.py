"""The system under test and its reference, found by the names a configuration gives:
``systems/<system>.py`` builds the port's scorer (``build_scorer``, ``score_kwargs``) and
``reference/<reference>.py`` is the plain reference (``build_modules``, ``Reference``,
``work_of``)."""

from __future__ import annotations

import torch

from portbench.harness import by_name

# the kernel libraries the scoring paths launch (K1, K2, K3, K4); built together at set-up
SCORING_KERNELS = ("fused_attention", "geglu_ff", "fused_readout", "streaming_attention")


def build_kernels(device: torch.device) -> None:
    """Compile (once a checkout) and load the scoring kernels, all at once: the first call
    would otherwise build them one after another."""
    if device.type == "cuda":
        from diffsim_tpu_torch.ops.kernels import build

        build.build(SCORING_KERNELS)


def of(config: dict):
    return by_name.module("systems", config["system"])


def reference_of(config: dict):
    return by_name.module("reference", config["reference"])
