"""SD-1.5, SDXL and DiT noise-schedule tables (the port's own copy of
``diffsim_tpu/core/schedulers.py``; numpy only).

The scorers need one closed form for the tensor that enters the network:

    x_model = a * x0 + b * eps,   eps ~ N(0, I)

plus a scalar ``model_t`` for the timestep embedding. ``(model_t, a, b)`` are computed on the
host as plain floats. Tables are float64 for exactness and cast at use sites.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

NUM_TRAIN_TIMESTEPS = 1000


def betas_scaled_linear(
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    n: int = NUM_TRAIN_TIMESTEPS,
) -> np.ndarray:
    """Stable-Diffusion "scaled_linear" beta schedule (linear in sqrt-beta)."""
    return np.linspace(beta_start**0.5, beta_end**0.5, n, dtype=np.float64) ** 2


def betas_linear(
    beta_start: float = 1e-4, beta_end: float = 0.02, n: int = NUM_TRAIN_TIMESTEPS
) -> np.ndarray:
    """ADM/DiT "linear" beta schedule (get_named_beta_schedule("linear"): scale =
    1000 / num_timesteps)."""
    scale = 1000.0 / n
    return np.linspace(scale * beta_start, scale * beta_end, n, dtype=np.float64)


@lru_cache(maxsize=None)
def alphas_cumprod(schedule: str = "scaled_linear", n: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    if schedule == "scaled_linear":
        betas = betas_scaled_linear(n=n)
    elif schedule == "linear":
        betas = betas_linear(n=n)
    else:
        raise ValueError(f"unknown beta schedule: {schedule}")
    out = np.cumprod(1.0 - betas)
    out.setflags(write=False)
    return out


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """``x_model = a * x0 + b * eps``; the network's timestep input is ``model_t``."""

    model_t: float
    a: float
    b: float


@lru_cache(maxsize=None)
def pndm_timestep_table(num_inference_steps: int = 1000, steps_offset: int = 1) -> np.ndarray:
    """The PLMS timestep list PNDMScheduler.set_timesteps builds with skip_prk_steps=True.

    For 1000 steps this is [1000, 999, 999, 998, ..., 1] (length 1001): the base table
    [1..1000] with its last-but-one entry duplicated, reversed. The canonical CUTE config
    ``target_step=600`` lands on DDPM t=401.
    """
    step_ratio = NUM_TRAIN_TIMESTEPS // num_inference_steps
    base = (np.arange(0, num_inference_steps) * step_ratio).round() + steps_offset
    table = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].astype(np.int64)
    table.setflags(write=False)
    return table


def sd15_noise_spec(target_step: int, num_inference_steps: int = 1000) -> NoiseSpec:
    """PNDM table index -> DDPM q_sample coefficients: a = sqrt(alpha_bar_t),
    b = sqrt(1 - alpha_bar_t). The noising index is clamped to 999 (t=1000 at
    target_step=0) while the raw value stays the model timestep."""
    table = pndm_timestep_table(num_inference_steps)
    t = int(table[target_step])
    ac = alphas_cumprod("scaled_linear")[min(t, NUM_TRAIN_TIMESTEPS - 1)]
    return NoiseSpec(model_t=float(t), a=float(np.sqrt(ac)), b=float(np.sqrt(1.0 - ac)))


@lru_cache(maxsize=None)
def _euler_sigmas(n: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    ac = alphas_cumprod("scaled_linear", n)
    sig = np.sqrt((1.0 - ac) / ac)
    sig.setflags(write=False)
    return sig


def euler_init_noise_sigma() -> float:
    sig = _euler_sigmas()
    return float(np.sqrt(sig.max() ** 2 + 1.0))


def sdxl_noise_spec(target_step: int, num_inference_steps: int = 1000) -> NoiseSpec:
    """SDXL: EulerDiscrete "leading" timesteps with offset 1 are [1000, 999, ..., 1], so
    t = 1000 - target_step. The reference pipeline scales the clean latents by
    ``init_noise_sigma``, adds sigma_t * eps and divides by sqrt(sigma_t^2 + 1), which reduces
    to a = init_noise_sigma * c_in, b = sigma_t * c_in: the image signal is amplified ~14.6x
    relative to a standard q_sample (quirk Q6, kept for parity). sigma_t comes from np.interp
    over the 1000-entry table, which clamps t = 1000 to index 999."""
    t = NUM_TRAIN_TIMESTEPS - target_step
    sig = _euler_sigmas()
    sigma_t = float(np.interp(float(t), np.arange(len(sig), dtype=np.float64), sig))
    c_in = 1.0 / np.sqrt(sigma_t**2 + 1.0)
    return NoiseSpec(model_t=float(t), a=float(euler_init_noise_sigma() * c_in),
                     b=float(sigma_t * c_in))


def space_timesteps(num_timesteps: int, section_counts: list[int]) -> list[int]:
    """OpenAI ADM uniform timestep respacing, as the JAX package re-derives it. Uses Python's
    ``round`` (banker's rounding), as the original does."""
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1.0 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return sorted(set(all_steps))


def dit_noise_spec(target_step: int) -> NoiseSpec:
    """DiT: noise with the SD-1.5 DDIM (scaled_linear) table at raw ``t = target_step``, but
    feed the model the timestep ``timestep_map[1000 - target_step]`` of the diffusion respaced
    to ``target_step`` steps. Needs target_step > 500, or the index is out of range, as in the
    reference."""
    idx = NUM_TRAIN_TIMESTEPS - target_step
    tmap = space_timesteps(NUM_TRAIN_TIMESTEPS, [target_step])
    if idx >= len(tmap):
        raise ValueError(
            f"target_step={target_step} gives respaced index {idx} >= {len(tmap)} "
            "(the reference crashes here too; use target_step > 500)"
        )
    ac = alphas_cumprod("scaled_linear")[min(target_step, NUM_TRAIN_TIMESTEPS - 1)]
    return NoiseSpec(model_t=float(tmap[idx]), a=float(np.sqrt(ac)), b=float(np.sqrt(1.0 - ac)))


def noise_spec(backbone: str, target_step: int) -> NoiseSpec:
    if backbone in ("sd15", "diffsim"):
        return sd15_noise_spec(target_step)
    if backbone in ("sdxl", "diffsim_xl"):
        return sdxl_noise_spec(target_step)
    if backbone in ("dit", "diffsim_dit"):
        return dit_noise_spec(target_step)
    raise ValueError(f"unknown backbone: {backbone}")
