"""``serve_open``: open-loop requests into the scoring service's in-process ``Batcher``
(``cli/serve.py``, ``max_batch`` pairs a round, ``max_wait_ms``) over the scorer's pair path
(``score_batch``), as the registry's adapter builds it. A request holds ``pairs_per_request``
pairs of new images (each size equally often), due at gaps that are the quantiles of an
exponential distribution of mean 1 / ``rate_per_s`` (Poisson arrivals with no spread in their
count). The gaps and sizes are shuffled once, by the mix's ``pattern_seed``, and cut into blocks
of ``block`` requests; a run's seed orders the blocks. So every seed offers the same bursts, in
another order. Rounds of ``warm_pairs`` pairs warm the shapes."""

from __future__ import annotations

import dataclasses
import types

import numpy as np

from portbench.harness import drive, traffic


@dataclasses.dataclass
class Request:
    due: float  # seconds after the window opens
    ring_idx: np.ndarray  # (2, pairs): [a images, b images]

    @property
    def pairs(self) -> int:
        return self.ring_idx.shape[1]


def schedule(mix: dict, seconds: float, ring: int, rng: np.random.Generator) -> list:
    """The requests due in a window of ``seconds``; ``rng`` (the run's) orders the blocks and
    picks the pixels."""
    rate = mix["rate_per_s"]
    n = max(1, int(round(rate * seconds)))
    pattern = np.random.default_rng(mix["pattern_seed"])
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    pattern.shuffle(gaps)
    lo, hi = mix["pairs_per_request"]
    sizes = lo + np.arange(n) % (hi - lo + 1)
    pattern.shuffle(sizes)
    k = mix["block"]
    order = np.concatenate([np.arange(b, min(b + k, n)) for b in rng.permutation(range(0, n, k))])
    gaps, sizes = gaps[order], sizes[order]
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return [Request(float(t), rng.integers(ring, size=(2, int(s)))) for t, s in zip(due, sizes)]


def prepare(run):
    """``loop(mix=None)``: one window; ``mix`` offers other parameters (the knee's sweep)."""
    from diffsim_tpu_torch.cli.serve import Batcher, _Work

    mix = run.mix
    ring = traffic.make_ring(np.random.default_rng([run.seed, 0]), mix["ring"],
                             run.config["img_size"])
    rounds = []
    score_pairs = drive.pair_scorer(run.scorer, run.kwargs, rounds)
    for p in mix["warm_pairs"]:
        idx = np.arange(2 * p) % len(ring)
        score_pairs(ring[idx[:p]], ring[idx[p:]], [run.kwargs["prompt"]] * p)
    rounds.clear()

    def loop(mix=mix):
        reqs = schedule(mix, run.seconds, mix["ring"], np.random.default_rng([run.seed, 2]))
        return drive.open_loop(Batcher, _Work, score_pairs, rounds, reqs, ring,
                               run.kwargs["prompt"], mix, run.scorer.device, run.seconds)
    return types.SimpleNamespace(ring=ring, loop=loop)
