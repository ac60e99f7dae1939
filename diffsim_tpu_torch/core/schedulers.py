"""SD-1.5 and SDXL noise-schedule tables (the port's own copy of the SD-1.5 and SDXL parts of
``diffsim_tpu/core/schedulers.py``; numpy only).

The scorer needs one closed form for the tensor that enters the UNet:

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


@lru_cache(maxsize=None)
def alphas_cumprod(schedule: str = "scaled_linear", n: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    if schedule != "scaled_linear":
        raise ValueError(f"unknown beta schedule: {schedule}")
    out = np.cumprod(1.0 - betas_scaled_linear(n=n))
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
