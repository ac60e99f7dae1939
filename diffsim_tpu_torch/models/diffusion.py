"""Gaussian diffusion (DDPM / DDIM) for DiT training and sampling.

Counterpart of ``diffsim_tpu/models/diffusion.py``: ``q_sample``, the posterior,
``p_mean_variance`` with the LEARNED_RANGE variance, the ancestral and DDIM sampling loops, the
hybrid MSE + VB training loss and uniform timestep respacing (``""``, ``"N"``, ``"ddimN"``).

Latents are NCHW, so the channel axis is 1 where the JAX package's is the last. The tables are
float64 numpy on the host and reach the device as float32, as in JAX. The sampling loops are
Python loops over the steps (the JAX package's ``lax.scan`` has no counterpart to port); each
takes an explicit ``torch.Generator`` and an optional initial ``noise``. Torch's generators draw
other numbers than JAX's keys, so the ancestral loop matches the JAX loop only in distribution;
the DDIM loop with ``eta=0`` draws nothing after its initial noise and matches it step for step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from diffsim_tpu_torch.core.schedulers import betas_linear, betas_scaled_linear, space_timesteps


@dataclasses.dataclass(frozen=True)
class Diffusion:
    """Schedule tables over (possibly respaced) timesteps. ``timestep_map[i]`` is the
    original-process timestep fed to the model at respaced step ``i``."""

    betas: np.ndarray
    timestep_map: np.ndarray
    learn_sigma: bool = True

    def __post_init__(self):
        betas = self.betas
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        host = {
            "sqrt_ac": np.sqrt(ac),
            "sqrt_1m_ac": np.sqrt(1.0 - ac),
            "sqrt_recip_ac": np.sqrt(1.0 / ac),
            "sqrt_recipm1_ac": np.sqrt(1.0 / ac - 1.0),
            "post_var": post_var,
            "post_log_var_clipped": np.log(np.append(post_var[1], post_var[1:])),
            "post_mean_x0": betas * np.sqrt(ac_prev) / (1.0 - ac),
            "post_mean_xt": (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
            "log_betas": np.log(betas),
            "ac": ac,
            "ac_prev": ac_prev,
            "model_t": self.timestep_map,
        }
        object.__setattr__(self, "tables", host)
        object.__setattr__(self, "_on_device", {})

    @property
    def num_steps(self) -> int:
        return len(self.betas)

    def _table(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(self.tables[name], dtype=torch.float32,
                                                   device=device)
        return self._on_device[key]

    def _g(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """The float32 table ``name`` at the (B,) steps ``t``, shaped to broadcast over a
        rank-``ndim`` batch."""
        out = self._table(name, t.device)[t]
        return out.reshape(out.shape + (1,) * (ndim - out.dim()))

    # ---- the forward process ----

    def q_sample(self, x0, t, noise):
        return self._g("sqrt_ac", t, x0.dim()) * x0 + self._g("sqrt_1m_ac", t, x0.dim()) * noise

    def q_posterior(self, x0, xt, t):
        mean = (self._g("post_mean_x0", t, x0.dim()) * x0
                + self._g("post_mean_xt", t, x0.dim()) * xt)
        return mean, self._g("post_log_var_clipped", t, x0.dim())

    # ---- the model ----

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """The model's (float32) timestep input at respaced steps ``t``."""
        return self._table("model_t", t.device)[t]

    def p_mean_variance(self, model_fn, x, t, clip_denoised: bool = True) -> dict:
        """``model_fn(x, model_t)`` -> (B, C or 2C, H, W): eps prediction, and with
        ``learn_sigma`` the LEARNED_RANGE interpolation between the clipped posterior and the
        beta log variance."""
        out = model_fn(x, self.model_t(t))
        c, n = x.shape[1], x.dim()
        if self.learn_sigma:
            eps, var_raw = out[:, :c], out[:, c:]
            frac = (var_raw.float() + 1.0) / 2.0
            log_var = (frac * self._g("log_betas", t, n)
                       + (1.0 - frac) * self._g("post_log_var_clipped", t, n))
        else:
            eps = out
            log_var = torch.log(torch.clamp(self._g("post_var", t, n), min=1e-20))
        xf = x.float()
        x0 = self._g("sqrt_recip_ac", t, n) * xf - self._g("sqrt_recipm1_ac", t, n) * eps.float()
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        mean, _ = self.q_posterior(x0, xf, t)
        return {"mean": mean, "log_var": log_var, "x0": x0, "eps": eps}

    # ---- sampling ----

    def _start(self, shape, generator, noise, rows):
        if noise is not None:
            return noise.float()[rows]
        return torch.randn(shape, generator=generator, device=generator.device)[rows]

    def _steps(self, x):
        for i in range(self.num_steps):
            step = self.num_steps - 1 - i
            yield step, torch.full((x.shape[0],), step, dtype=torch.long, device=x.device)

    def p_sample_loop(self, model_fn, shape, generator: torch.Generator | None = None,
                      clip_denoised: bool = True, noise: torch.Tensor | None = None,
                      rows: slice = slice(None)):
        """Ancestral sampling over every step; returns the x0 samples. Each step but the last
        draws its noise from ``generator``. Every draw (and ``noise``) has the batch's whole
        ``shape``, and only its ``rows`` are sampled: a process group's ranks each take their
        block, as one card would draw it."""
        x = self._start(shape, generator, noise, rows)
        for step, t in self._steps(x):
            out = self.p_mean_variance(model_fn, x, t, clip_denoised)
            x = out["mean"]
            if step > 0:
                z = torch.randn(shape, generator=generator, device=x.device)[rows]
                x = x + torch.exp(0.5 * out["log_var"]) * z
        return x

    def ddim_sample_loop(self, model_fn, shape, generator: torch.Generator | None = None,
                         eta: float = 0.0, clip_denoised: bool = True,
                         noise: torch.Tensor | None = None, rows: slice = slice(None)):
        """DDIM sampling; with ``eta > 0`` each step but the last draws from ``generator``.
        ``rows`` as in :meth:`p_sample_loop`."""
        x = self._start(shape, generator, noise, rows)
        n = len(shape)
        for step, t in self._steps(x):
            out = self.p_mean_variance(model_fn, x, t, clip_denoised)
            eps = (self._g("sqrt_recip_ac", t, n) * x - out["x0"]) / self._g("sqrt_recipm1_ac",
                                                                              t, n)
            ac, ac_prev = self._g("ac", t, n), self._g("ac_prev", t, n)
            sigma = eta * torch.sqrt((1 - ac_prev) / (1 - ac)) * torch.sqrt(1 - ac / ac_prev)
            x = out["x0"] * torch.sqrt(ac_prev) + torch.sqrt(1 - ac_prev - sigma**2) * eps
            if eta > 0 and step > 0:
                x = x + sigma * torch.randn(shape, generator=generator, device=x.device)[rows]
        return x

    # ---- training ----

    def training_losses(self, model_fn, x0, t, noise, vb_weight: float = 1.0) -> dict:
        """The hybrid loss: the MSE on eps plus, with ``learn_sigma``, the VB term with the
        eps prediction detached (the variance alone learns from it), scaled by
        ``num_steps / 1000``. Per-example losses."""
        xt = self.q_sample(x0.float(), t, noise)
        out = model_fn(xt.to(x0.dtype), self.model_t(t))
        c = x0.shape[1]
        if self.learn_sigma:
            eps, var_raw = out[:, :c], out[:, c:]
            frozen = torch.cat([eps.detach(), var_raw], dim=1)
            vb = self._vb_terms(lambda x_, mt_: frozen, x0, xt, t) * (self.num_steps / 1000.0)
        else:
            eps = out
            vb = 0.0
        mse = ((noise - eps.float()) ** 2).mean(dim=tuple(range(1, x0.dim())))
        return {"mse": mse, "vb": vb, "loss": mse + vb_weight * vb}

    def _vb_terms(self, model_fn, x0, xt, t):
        true_mean, true_log_var = self.q_posterior(x0.float(), xt, t)
        out = self.p_mean_variance(model_fn, xt, t, clip_denoised=False)
        axes = tuple(range(1, x0.dim()))
        kl = _normal_kl(true_mean, true_log_var, out["mean"], out["log_var"])
        kl = kl.mean(dim=axes) / math.log(2.0)
        nll = -_discretized_gaussian_log_likelihood(x0.float(), out["mean"], 0.5 * out["log_var"])
        nll = nll.mean(dim=axes) / math.log(2.0)
        return torch.where(t == 0, nll, kl)


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_std_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def _discretized_gaussian_log_likelihood(x, means, log_scales):
    """The log-likelihood of data discretised to 255 bins under a Gaussian (improved DDPM's
    decoder term)."""
    centered = x - means
    inv_std = torch.exp(-log_scales)
    plus = _approx_std_normal_cdf(inv_std * (centered + 1.0 / 255.0))
    minus = _approx_std_normal_cdf(inv_std * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(plus, min=1e-12))
    log_1m_cdf_minus = torch.log(torch.clamp(1.0 - minus, min=1e-12))
    log_delta = torch.log(torch.clamp(plus - minus, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_1m_cdf_minus, log_delta))


def create_diffusion(timestep_respacing: str | int | None = None, noise_schedule: str = "linear",
                     learn_sigma: bool = True, diffusion_steps: int = 1000) -> Diffusion:
    """Respacing ``""`` or None: every step; ``"N"``: N uniform steps; ``"ddimN"``: DDIM
    striding. Respaced betas are 1 - ac[s_i] / ac[s_{i-1}]."""
    base_betas = (betas_linear(n=diffusion_steps) if noise_schedule == "linear"
                  else betas_scaled_linear(n=diffusion_steps))
    if timestep_respacing in (None, ""):
        use = list(range(diffusion_steps))
    elif isinstance(timestep_respacing, str) and timestep_respacing.startswith("ddim"):
        want = int(timestep_respacing[4:])
        stride = next(i for i in range(1, diffusion_steps)
                      if len(range(0, diffusion_steps, i)) == want)
        use = list(range(0, diffusion_steps, stride))
    else:
        use = space_timesteps(diffusion_steps, [int(timestep_respacing)])
    ac = np.cumprod(1.0 - base_betas)
    last, new_betas = 1.0, []
    for s in use:
        new_betas.append(1.0 - ac[s] / last)
        last = ac[s]
    return Diffusion(betas=np.asarray(new_betas, np.float64),
                     timestep_map=np.asarray(use, np.int64), learn_sigma=learn_sigma)
