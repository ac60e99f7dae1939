"""Training timestep samplers: uniform, and importance sampling by the loss's second moment.

The port's own copy of ``diffsim_tpu/train/timestep_sampler.py`` (numpy only). The loss-aware
sampler draws t with probability p(t) proportional to sqrt(E[loss(t)^2]), floored by a uniform
share, and weights each example's loss by 1 / (T p(t)) so the objective stays unbiased. Its
history is updated on the host between steps; the step receives explicit (t, weights).
"""

from __future__ import annotations

import numpy as np


class UniformSampler:
    def __init__(self, num_steps: int):
        self.num_steps = num_steps

    def sample(self, rng: np.random.Generator, batch: int):
        t = rng.integers(0, self.num_steps, batch).astype(np.int32)
        return t, np.ones(batch, np.float32)

    def update(self, t, losses):
        pass


class LossSecondMomentSampler:
    """Keeps the last ``history`` per-timestep losses; before every timestep has a full
    history the sampler stays uniform (the published warm-up behavior)."""

    def __init__(self, num_steps: int, history: int = 10, uniform_prob: float = 0.001):
        self.num_steps = num_steps
        self.history = history
        self.uniform_prob = uniform_prob
        self._losses = np.zeros((num_steps, history), np.float64)
        self._counts = np.zeros(num_steps, np.int64)

    @property
    def warmed_up(self) -> bool:
        return bool((self._counts >= self.history).all())

    def weights(self) -> np.ndarray:
        if not self.warmed_up:
            return np.ones(self.num_steps, np.float64) / self.num_steps
        w = np.sqrt(np.mean(self._losses**2, axis=-1))
        w = w / w.sum()
        w = w * (1 - self.uniform_prob) + self.uniform_prob / self.num_steps
        return w

    def sample(self, rng: np.random.Generator, batch: int):
        p = self.weights()
        t = rng.choice(self.num_steps, size=batch, p=p).astype(np.int32)
        weights = (1.0 / (self.num_steps * p[t])).astype(np.float32)
        return t, weights

    def update(self, t: np.ndarray, losses: np.ndarray):
        for ti, li in zip(np.asarray(t).ravel(), np.asarray(losses).ravel()):
            slot = int(self._counts[ti] % self.history)
            self._losses[ti, slot] = float(li)
            self._counts[ti] += 1
