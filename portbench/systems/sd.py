"""The system under test for the Stable Diffusion backbones: the port's scorer that a
configuration's ``scorer`` names (``module:Class``), built through its public constructor at
the configuration's sizes and holding the benchmark's weights, and the arguments of its calls."""

from __future__ import annotations

import importlib

from portbench.harness.weights import DTYPES


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_scorer(config: dict, device, weights: dict):
    """The configuration's scorer on ``device``, its parts loaded (strictly, by name) with
    ``weights`` {part: state dict}, each cast to the dtype its part is served in."""
    from diffsim_tpu_torch.models.clip_text import CLIPTextConfig
    from diffsim_tpu_torch.models.unet import UNetConfig
    from diffsim_tpu_torch.models.vae import VAEConfig

    mod, cls = config["scorer"].split(":")
    kw = dict(unet_cfg=UNetConfig(**_tuples(config["unet"])),
              vae_cfg=VAEConfig(**_tuples(config["vae"])),
              text_cfg=CLIPTextConfig(**config["text"]), img_size=config["img_size"],
              dtype=DTYPES[config["dtype"]], device=device, **config["options"])
    if "text2" in config:
        kw["text2_cfg"] = CLIPTextConfig(**config["text2"])
    scorer = getattr(importlib.import_module(mod), cls)(None, **kw)
    for part, state in weights.items():
        getattr(scorer, part).load_state_dict(state, strict=True)
    return scorer


def score_kwargs(config: dict) -> dict:
    """The scoring arguments of the configuration's calls (tap, step, similarity, seed,
    prompt)."""
    sc = config["score"]
    layer = sc["target_layer"]
    return dict(prompt=sc["prompt"], target_block=sc["target_block"],
                target_layer=tuple(layer) if isinstance(layer, list) else layer,
                target_step=sc["target_step"], similarity=sc["similarity"], seed=sc["seed"])
